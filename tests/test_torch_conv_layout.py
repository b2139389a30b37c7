"""The grouped convolutions' one memory layout (``models.nn``'s
"Layouts"): client activations stored client-minor, every convolution
handed a channels-last input, nothing converted to NCHW.

* (a) every ``F.conv2d`` / ``F.conv_transpose2d`` call of a two-layer
  client stack and of a server layer receives a ``torch.channels_last``
  input;
* (b) the tensor between two client layers is the first layer's
  activation output itself: its grouped view shares its storage, and
  the second layer counts no layout copy;
* (c) forward values and input and weight gradients equal the NCHW
  grouping the layers used before (kept below as plain code) to 1e-5;
* (d) a tiny G and D ``segments.make_apply`` counts one layout copy per
  boundary where rows change owner or a client-major tensor meets a
  client convolution, and none per client convolution.

Cases: conv and transposed conv; stride 1 and 2; kernel 3 and 4;
"SAME", "VALID" and explicit padding; K = 1 and K = 3.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import latency, segments, splitting
from repro_torch.models import gan, nn
from repro_torch.tree import tree_map
from torch_threads import one_torch_thread  # noqa: F401

B, H, C1, C2, C3 = 2, 12, 4, 6, 5
PADS = {"SAME": "SAME", "VALID": "VALID", "explicit": ((1, 2), (2, 0))}
CASES = [(kind, s, k, pad, K) for kind in ("conv", "convT")
         for s in (1, 2) for k in (3, 4) for pad in PADS for K in (1, 3)]


def _layer(kind):
    return ((nn.conv2d_init, nn.conv2d_apply) if kind == "conv"
            else (nn.convT2d_init, nn.convT2d_apply))


def _stack(kind, k, K, gen):
    init, _ = _layer(kind)
    return (init(K, C1, C2, k, gen, "cpu"), nn.batchnorm_init(K, C2, "cpu"),
            init(K, C2, C3, k, gen, "cpu"))


def _two_layers(kind, s, k, pad, p1, bn, p2, x):
    """conv -> BatchNorm -> leaky ReLU -> conv; returns (the activation
    between the layers, the output)."""
    _, apply = _layer(kind)
    h = apply(p1, x, stride=s, padding=PADS[pad])
    h, _ = nn.batchnorm_apply(bn, h, train=True)
    a = nn.leaky_relu(h)
    return a, apply(p2, a, stride=s, padding=PADS[pad])


def _spy(monkeypatch):
    """Wrap both convolutions: the list of the inputs they receive."""
    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        real = getattr(F, name)

        def wrapped(x, *args, real=real, **kw):
            seen.append(x)
            return real(x, *args, **kw)
        monkeypatch.setattr(F, name, wrapped)
    return seen


def _channels_last(x):
    return x.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("kind,s,k,pad,K", CASES)
def test_client_stack_is_channels_last_without_copies(monkeypatch, kind, s,
                                                      k, pad, K):
    """(a) and (b) on a client stack fed client-major rows (one counted
    copy into client-minor, at its first layer, where K > 1)."""
    gen = torch.Generator().manual_seed(0)
    p1, bn, p2 = _stack(kind, k, K, gen)
    x = torch.randn(K, B, H, H, C1, generator=gen)
    seen = _spy(monkeypatch)
    before = nn.layout_copies
    a, y = _two_layers(kind, s, k, pad, p1, bn, p2, x)
    assert len(seen) == 2 and all(_channels_last(t) for t in seen)
    assert nn.layout_copies - before == (1 if K > 1 else 0)
    grouped = nn._to_grouped(a)
    assert grouped.untyped_storage().data_ptr() == \
        a.untyped_storage().data_ptr() and _channels_last(grouped)
    assert nn.layout_copies - before == (1 if K > 1 else 0)
    # the output is client-minor too: the next layer copies nothing
    assert nn.client_minor(y) is y


@pytest.mark.parametrize("kind,s,k,pad", [c[:4] for c in CASES if c[4] == 1])
def test_server_layer_is_channels_last_without_copies(monkeypatch, kind, s, k,
                                                      pad):
    """(a) on a server layer: rows ``[N, H, W, C]`` run as K = 1."""
    gen = torch.Generator().manual_seed(1)
    init, apply = _layer(kind)
    p = init(1, C1, C2, k, gen, "cpu")
    rows = torch.randn(3 * B, H, H, C1, generator=gen)
    seen = _spy(monkeypatch)
    before = nn.layout_copies
    apply(p, rows[None], stride=s, padding=PADS[pad])
    assert len(seen) == 1 and _channels_last(seen[0])
    assert nn.layout_copies == before


# -- the NCHW grouping the layers used before, as plain code ----------------

def _old_to_grouped(x):
    K, b, H_, W, C = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, K * C, H_, W)


def _old_from_grouped(y, K):
    b, KO, H_, W = y.shape
    return y.reshape(b, K, KO // K, H_, W).permute(1, 0, 3, 4, 2)


def _old_conv(p, x, stride, padding):
    K, _, H_, W, _ = x.shape
    w = p["w"]
    O, I, kh, kw = w.shape[1:]
    if padding == "SAME":
        ph, pw = nn.same_pads(H_, kh, stride), nn.same_pads(W, kw, stride)
    elif padding == "VALID":
        ph, pw = (0, 0), (0, 0)
    else:
        ph, pw = padding
    xg = F.pad(_old_to_grouped(x).contiguous(), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xg, w.reshape(K * O, I, kh, kw), stride=stride, groups=K)
    return _old_from_grouped(y, K) + p["b"][:, None, None, None, :]


def _old_convT(p, x, stride, padding):
    K, _, H_, W, _ = x.shape
    w = p["w"]
    I, O, kh, kw = w.shape[1:]
    wg = w.reshape(K * I, O, kh, kw)
    xg = _old_to_grouped(x).contiguous()
    if padding == "SAME":
        (bh, ah), (bw, aw) = nn.conv_transpose_pads(kh, stride), \
            nn.conv_transpose_pads(kw, stride)
        y = F.conv_transpose2d(
            xg, wg, stride=stride, padding=(kh - 1 - bh, kw - 1 - bw),
            output_padding=(max(ah - bh, 0), max(aw - bw, 0)), groups=K)
        y = y[:, :, :H_ * stride, :W * stride]
    else:
        if padding == "VALID":
            ph = nn.conv_transpose_valid_pads(kh, stride)
            pw = nn.conv_transpose_valid_pads(kw, stride)
        else:
            ph, pw = padding
        y = F.conv_transpose2d(xg, wg, stride=stride, groups=K)
        y = F.pad(y, (pw[0] - (kw - 1), pw[1] - (kw - 1),
                      ph[0] - (kh - 1), ph[1] - (kh - 1)))
    return _old_from_grouped(y, K) + p["b"][:, None, None, None, :]


@pytest.mark.parametrize("kind,s,k,pad,K", CASES)
def test_matches_the_nchw_grouping(kind, s, k, pad, K):
    """(c) one layer, forward and backward, against the NCHW grouping."""
    gen = torch.Generator().manual_seed(2)
    init, apply = _layer(kind)
    old = _old_conv if kind == "conv" else _old_convT
    p = init(K, C1, C2, k, gen, "cpu")
    p["b"] = torch.randn(p["b"].shape, generator=gen)
    x = torch.randn(K, B, H, H, C1, generator=gen)
    runs = []
    for fn in (apply, old):
        xi = x.clone().requires_grad_(True)
        pi = {n: t.clone().requires_grad_(True) for n, t in p.items()}
        y = fn(pi, xi, stride=s, padding=PADS[pad])
        cot = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        (y * cot).sum().backward()
        runs.append((y.detach(), xi.grad, pi["w"].grad, pi["b"].grad))
    for new, want in zip(*runs):
        torch.testing.assert_close(new, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K", [1, 3])
def test_grouped_input_gradient_runs_in_nchw(monkeypatch, K):
    """A grouped convolution's input gradient is cuDNN's backward-data on
    NCHW tensors (two counted copies: the output gradient in, the input
    gradient out, channels-last again); its weight gradient stays
    channels-last. A server layer (K = 1) keeps autograd's own
    backward."""
    gen = torch.Generator().manual_seed(4)
    p = nn.conv2d_init(K, C1, C2, 4, gen, "cpu")
    x = torch.randn(B, H, H, K, C1, generator=gen).permute(3, 0, 1, 2, 4)
    x.requires_grad_(True)
    y = nn.conv2d_apply(p, x, stride=2)
    calls = []
    real = torch.ops.aten.convolution_backward

    def spy(gy, inp, *args):
        calls.append((gy.is_contiguous(), args[-1]))
        return real(gy, inp, *args)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", spy)
    before = nn.layout_copies
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    if K > 1:
        assert nn.layout_copies - before == 2
        assert calls == [(True, (True, False, False))]
        assert nn.client_minor(x.grad) is x.grad
    else:
        assert nn.layout_copies == before


# -- the copies of a split program ------------------------------------------

def _groups():
    """a (K=2) keeps only layer 0 before the server and layer 4 after
    it; b (K=3) and c (K=1) keep layers 0-1 and 3-4."""
    dev = latency.PAPER_DEVICES
    spec = [("a", latency.Cut(1, 4, 1, 4), [0, 1]),
            ("b", latency.Cut(2, 3, 2, 3), [2, 3, 4]),
            ("c", latency.Cut(2, 3, 2, 3), [5])]
    return [splitting.ProfileGroup(n, dev[i], cut, ids)
            for i, (n, cut, ids) in enumerate(spec)]


def _params(groups, net, gen):
    defs = gan.NET_LAYER_DEFS[net]
    client = {g.name: {str(l): defs[l].init(g.size, gen, "cpu")
                       for l in splitting.client_owned_layers(
                           splitting.layer_pair(g.cut, net), len(defs))}
              for g in groups}
    server = {str(l): tree_map(lambda t: t[0], defs[l].init(1, gen, "cpu"))
              for l in splitting.server_union_span(groups, net, len(defs))}
    return client, server


# Per forward pass, with every server step joining a and the others at
# layer 2 (a alone at layers 1 and 3):
# G: b's dense layer-0 output into its layer-1 conv (1); the join at
#    layer 2 (1: one cat, or with concat_groups=False b's client-minor
#    rows alone, 1); the tails' first convs fed server rows: a's layer 4
#    and b's layer 3 (2). a reaches the server from its dense layer 0,
#    client-major: a view. c (K = 1) needs no copy anywhere.
# D: each group's layer-0 input written client-minor (3); a's layer-0
#    conv output into server layer 1 (1); the join at layer 2 (1); b's
#    tail conv at layer 3 (1). a's tail is the dense layer 4: no conv.
COPIES = {"G": 4, "D": 6}


@pytest.mark.parametrize("net", ["G", "D"])
@pytest.mark.parametrize("concat_groups", [True, False])
def test_make_apply_copies_only_at_boundaries(monkeypatch, net,
                                              concat_groups):
    """(d) and (a) on a split program: the layout copies of one forward
    pass are its boundaries', and every convolution gets channels-last."""
    gen = torch.Generator().manual_seed(3)
    groups = _groups()
    client, server = _params(groups, net, gen)
    if net == "G":
        inputs = {g.name: (torch.randn(g.size, B, gan.Z_DIM, generator=gen),
                           torch.randint(0, 10, (g.size, B), generator=gen))
                  for g in groups}
    else:
        inputs = {g.name: (torch.rand(g.size, B, 28, 28, 1, generator=gen),
                           torch.randint(0, 10, (g.size, B), generator=gen))
                  for g in groups}
    apply = segments.make_apply(
        segments.compile_split_program(groups, net),
        concat_groups=concat_groups)
    seen = _spy(monkeypatch)
    before = nn.layout_copies
    out, _, _, _ = apply(client, server, inputs, True)
    assert nn.layout_copies - before == COPIES[net]
    assert seen and all(_channels_last(t) for t in seen)
    assert {g: tuple(y.shape[:2]) for g, y in out.items()} == \
        {g.name: (g.size, B) for g in groups}
