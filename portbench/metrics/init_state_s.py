"""Seconds of the program's ``huscf.init.state`` span, the trainer's
weight draws at construction (``HuSCFTrainer._init_state``), in this
run's set-up."""
from portbench import records


def read(ctx):
    recs = records.setup_records(ctx)
    if recs is None:
        return None
    return records.named(recs, "huscf.init.state")[0].seconds
