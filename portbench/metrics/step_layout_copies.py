"""Activation copies one training step makes to give its convolutions
their layout (``repro_torch.models.nn.layout_copies``: a client-major
tensor made client-minor for a client convolution, D's layer-0 input,
rows joined for the server, and a grouped convolution's input gradient
taken through NCHW and back), as the program records them on its
newest record that carries ``layout_copies``: the captured step's
``huscf.graphs.capture`` span on the card, an eager step's
``huscf.train_steps.launch`` span on the CPU. A whole number, counted
once per capture, so replays cost nothing; nothing where the program
records no such count."""
from portbench import records


def read(ctx):
    recs = records.all_records()
    for r in reversed(recs or ()):
        n = r.attrs.get("layout_copies")
        if n is not None:
            return int(n)
    return None
