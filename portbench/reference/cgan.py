"""The split conditional GAN of the HuSCF-GAN paper (Table 3) and its
training step, in plain PyTorch and float32, written from the paper and
the configuration file's numbers alone.

A split network: for layer ``l`` of G or D, client ``k`` either owns the
layer (its own copy of the parameters, BatchNorm statistics over its own
``b`` rows) or hands it to the server (one shared copy, BatchNorm
statistics over the rows of every client the server runs at that layer).
Which clients own which layers is the cut topology (``owners``); the
step is otherwise the paper's: a D update on real and generated images,
then a G update against the updated D, both with Adam, non-saturating
BCE losses averaged over every client's rows.

Layouts: activations are ``[K, b, C, H, W]``; a dense weight is ``[in,
out]``, a convolution's ``[out, in, k, k]``, a transposed convolution's
``[in, out, k, k]`` (``F.conv_transpose2d``'s), an embedding table
``[classes, dim]``. Every layer's output size follows "SAME" padding:
a strided convolution gives ``ceil(size / stride)`` with the odd pixel
padded after, a transposed one ``size * stride``. The generator's first
layer reshapes its dense output as H, W, C; the discriminator's last
flattens H, W, C; the middle activation of a client is its batch mean of
D's middle layer's output, flattened H, W, C.

Precision: ``precision("fp32")`` (TF32 off, the configuration's) or
``precision("tf32")``, the control: TF32 products on a card, and on the
CPU the products' operands rounded to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.func import vmap

Leaves = Dict[Tuple[int, str, str], torch.Tensor]   # (layer, side, path)
STATS = ("bn.mean", "bn.var")

_EMULATE_TF32 = False


@contextlib.contextmanager
def precision(mode: str):
    """Products in float32 (``fp32``, TF32 off) or in TF32 (``tf32``)."""
    global _EMULATE_TF32
    if mode not in ("fp32", "tf32"):
        raise ValueError(mode)
    tf32 = mode == "tf32"
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _EMULATE_TF32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _EMULATE_TF32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _EMULATE_TF32) = old


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest
    even; the gradient passes straight through."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return t + (i.view(torch.float32) - t).detach()


def _rnd(t: torch.Tensor) -> torch.Tensor:
    """An operand of a product: rounded to TF32 under the CPU's control
    (the card rounds its TF32 products' operands itself)."""
    if not _EMULATE_TF32 or t.is_cuda:
        return t
    return tf32_round(t)


# ---------------------------------------------------------------------------
# the network from the configuration's numbers
# ---------------------------------------------------------------------------

def layer_specs(model: dict, net: str) -> List[dict]:
    return model["generator" if net == "G" else "discriminator"]


def leaf_shapes(model: dict, spec: dict) -> Dict[str, Tuple[int, ...]]:
    """Each parameter of one copy of a layer, by path, with its shape."""
    kind = spec["kind"]
    ncls = model["num_classes"]
    out: Dict[str, Tuple[int, ...]] = {}
    if kind == "embed_dense":
        h, w, c = spec["out_hwc"]
        out["embed.table"] = (ncls, spec["embed_dim"])
        out["fc.w"] = (spec["in_dim"], h * w * c)
        out["fc.b"] = (h * w * c,)
        ch = c
    elif kind in ("conv", "embed_conv"):
        if kind == "embed_conv":
            out["embed.table"] = (ncls, spec["embed_dim"])
        out["conv.w"] = (spec["cout"], spec["cin"], spec["k"], spec["k"])
        out["conv.b"] = (spec["cout"],)
        ch = spec["cout"]
    elif kind == "convt":
        out["convt.w"] = (spec["cin"], spec["cout"], spec["k"], spec["k"])
        out["convt.b"] = (spec["cout"],)
        ch = spec["cout"]
    elif kind == "dense":
        out["fc.w"] = (spec["in_dim"], spec["out_dim"])
        out["fc.b"] = (spec["out_dim"],)
        ch = spec["out_dim"]
    else:
        raise ValueError(f"layer kind {kind!r}")
    if spec["bn"]:
        for p in ("scale", "bias", "mean", "var"):
            out[f"bn.{p}"] = (ch,)
    return out


def layer_width(model: dict, spec: dict) -> int:
    """Floats in one copy of a layer, BatchNorm's running statistics
    included."""
    return sum(math.prod(s) for s in leaf_shapes(model, spec).values())


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def convt_pads(k: int, s: int) -> Tuple[int, int]:
    """(padding, output_padding) of ``F.conv_transpose2d`` for "SAME":
    output ``size * s``, the stride-dilated input padded ``k - 1 - p``
    before and the rest after."""
    total = k + s - 2
    before = k - 1 if s > k - 1 else -(-total // 2)
    return k - 1 - before, (total - before) - before


def _bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.bmm(_rnd(a), _rnd(w))


def _bn(x, scale, bias, eps):
    """Per copy: statistics over every axis but the copy and the
    channel (axis 2); returns (y, batch mean, biased batch variance)."""
    dims = (1,) + tuple(range(3, x.ndim))
    mean = x.mean(dims)
    var = x.var(dims, correction=0)
    shape = (x.shape[0], 1, x.shape[2]) + (1,) * (x.ndim - 3)
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    return y * scale.reshape(shape) + bias.reshape(shape), mean, var


def _act(x, act: str, slope: float):
    if act == "relu":
        return torch.relu(x)
    if act == "lrelu":
        return F.leaky_relu(x, slope)
    if act == "tanh":
        return torch.tanh(x)
    return x


def apply_layer(model: dict, spec: dict, p: Dict[str, torch.Tensor], x,
                train: bool = True):
    """One layer on ``G`` copies: parameters ``[G, ...]``, input ``[G,
    N, ...]`` (a tuple for a first layer). Returns (y, (mean, var) of
    its BatchNorm or None)."""
    kind = spec["kind"]
    G = p[next(iter(p))].shape[0]
    gi = torch.arange(G, device=p[next(iter(p))].device)[:, None]
    if kind == "embed_dense":
        z, y = x
        e = p["embed.table"][gi, y.long()]
        h = _bmm(torch.cat([z, e], -1), p["fc.w"]) + p["fc.b"][:, None, :]
        H, W, C = spec["out_hwc"]
        h = h.reshape(G, h.shape[1], H, W, C).permute(0, 1, 4, 2, 3)
    elif kind in ("conv", "embed_conv"):
        if kind == "embed_conv":
            img, y = x
            e = p["embed.table"][gi, y.long()]
            e = e.reshape(img.shape[:2] + (1,) + img.shape[3:])
            x = torch.cat([img, e], 2)
        k, s = spec["k"], spec["stride"]
        ph = same_pads(x.shape[3], k, s)
        pw = same_pads(x.shape[4], k, s)
        h = vmap(lambda a, w: F.conv2d(
            F.pad(a, (pw[0], pw[1], ph[0], ph[1])), w,
            stride=s))(_rnd(x), _rnd(p["conv.w"]))
        h = h + p["conv.b"][:, None, :, None, None]
    elif kind == "convt":
        k, s = spec["k"], spec["stride"]
        pad, opad = convt_pads(k, s)
        h = vmap(lambda a, w: F.conv_transpose2d(
            a, w, stride=s, padding=pad, output_padding=opad))(
                _rnd(x), _rnd(p["convt.w"]))
        h = h + p["convt.b"][:, None, :, None, None]
    elif kind == "dense":
        flat = x.permute(0, 1, 3, 4, 2).reshape(G, x.shape[1], -1)
        h = (_bmm(flat, p["fc.w"]) + p["fc.b"][:, None, :])[..., 0]
        return h, None
    else:
        raise ValueError(kind)
    stats = None
    if spec["bn"]:
        if train:
            h, mean, var = _bn(h, p["bn.scale"], p["bn.bias"],
                               model["bn_eps"])
            stats = (mean, var)
        else:
            shape = (G, 1, h.shape[2], 1, 1)
            h = ((h - p["bn.mean"].reshape(shape))
                 / torch.sqrt(p["bn.var"].reshape(shape) + model["bn_eps"])
                 * p["bn.scale"].reshape(shape)
                 + p["bn.bias"].reshape(shape))
    return _act(h, spec["act"], model["leaky_slope"]), stats


def _take(x, idx):
    if isinstance(x, tuple):
        return tuple(t.index_select(0, idx) for t in x)
    return x.index_select(0, idx)


def _merge(x):
    """``[n, b, ...]`` rows of n clients as one server copy ``[1, n*b,
    ...]``."""
    if isinstance(x, tuple):
        return tuple(_merge(t) for t in x)
    return x.reshape((1, x.shape[0] * x.shape[1]) + x.shape[2:])


def net_forward(model: dict, net: str, leaves: Leaves,
                topo: Sequence[Tuple[torch.Tensor, torch.Tensor]], x,
                K: int, capture_middle: bool = False):
    """The whole net over all ``K`` clients' inputs ``[K, b, ...]``:
    ``topo[l] = (owners, users)`` of layer l (client ids). Returns
    (output [K, b, ...], {(l, side): (mean, var)}, middle [K, F] or
    None)."""
    specs = layer_specs(model, net)
    stats = {}
    middle = None
    for l, spec in enumerate(specs):
        owners, users = topo[l]
        b = (x[0] if isinstance(x, tuple) else x).shape[1]
        parts = []
        for side, ids in (("client", owners), ("server", users)):
            if ids.numel() == 0:
                continue
            p = {path: t if side == "client" else t[None]
                 for (ll, s, path), t in leaves.items()
                 if ll == l and s == side}
            xin = _take(x, ids)
            if side == "server":
                xin = _merge(xin)
            y, st = apply_layer(model, spec, p, xin)
            if side == "server":
                y = y.reshape((ids.numel(), b) + y.shape[2:])
                if st is not None:
                    st = (st[0][0], st[1][0])
            if st is not None:
                stats[(l, side)] = st
            parts.append((ids, y))
        first = parts[0][1]
        out = first.new_zeros((K,) + first.shape[1:])
        for ids, y in parts:
            out = out.index_copy(0, ids, y)
        x = out
        if capture_middle and l == model["middle_layer"]:
            middle = x.permute(0, 1, 3, 4, 2).mean(1).reshape(K, -1)
    return x, stats, middle


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def learnable(leaves: Leaves) -> List[Tuple[int, str, str]]:
    return [key for key in leaves if key[2] not in STATS]


class Adam:
    """Adam with bias corrections, eps outside the square root."""

    def __init__(self, model: dict, leaves: Leaves, keys):
        self.lr, self.b1 = model["lr"], model["adam_b1"]
        self.b2, self.eps = model["adam_b2"], model["adam_eps"]
        self.m = {k: torch.zeros_like(leaves[k]) for k in keys}
        self.v = {k: torch.zeros_like(leaves[k]) for k in keys}
        self.t = 0

    @torch.no_grad()
    def update(self, leaves: Leaves, grads: Dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            step = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                        + self.eps)
            leaves[k] = leaves[k] - self.lr * step


@torch.no_grad()
def _set_stats(model: dict, leaves: Leaves, stats) -> None:
    m = model["bn_momentum"]
    for (l, side), (mean, var) in stats.items():
        leaves[(l, side, "bn.mean")] = (m * leaves[(l, side, "bn.mean")]
                                        + (1 - m) * mean)
        leaves[(l, side, "bn.var")] = (m * leaves[(l, side, "bn.var")]
                                       + (1 - m) * var)


class SplitGAN:
    """The reference's state: both nets' leaves, both Adams, the middle
    activation EMA; ``step`` is one training step."""

    def __init__(self, model: dict, G: Leaves, D: Leaves, topo_g, topo_d,
                 K: int):
        self.model, self.K = model, K
        self.G, self.D = dict(G), dict(D)
        self.topo_g, self.topo_d = topo_g, topo_d
        self.opt_g = Adam(model, self.G, learnable(self.G))
        self.opt_d = Adam(model, self.D, learnable(self.D))
        self.ema: Optional[torch.Tensor] = None

    def _fwd(self, net, leaves, x, capture_middle=False):
        topo = self.topo_g if net == "G" else self.topo_d
        return net_forward(self.model, net, leaves, topo, x, self.K,
                           capture_middle)

    def step(self, batch: Dict[str, torch.Tensor]):
        """One D then G update on ``batch`` (``z``, ``fake_y``,
        ``real_img`` [K, b, C, H, W], ``real_y``). Returns (loss_d,
        loss_g, D's gradients, G's gradients) by leaf."""
        z, fy = batch["z"], batch["fake_y"]
        with torch.no_grad():
            fake, _, _ = self._fwd("G", self.G, (z, fy))
        keys = learnable(self.D)
        var = {k: self.D[k].detach().requires_grad_(True) for k in keys}
        d = {**self.D, **var}
        real, stats_d, mid = self._fwd("D", d, (batch["real_img"],
                                                batch["real_y"]), True)
        fk, _, _ = self._fwd("D", d, (fake, fy))
        loss_d = bce(real, 1.0) + bce(fk, 0.0)
        gd = dict(zip(keys, torch.autograd.grad(loss_d, list(var.values()))))
        self.opt_d.update(self.D, gd)
        _set_stats(self.model, self.D, {k: (m.detach(), v.detach())
                                        for k, (m, v) in stats_d.items()})
        mid = mid.detach()
        decay = self.model["ema_decay"]
        self.ema = mid if self.ema is None else (
            decay * self.ema + (1 - decay) * mid)

        keys = learnable(self.G)
        var = {k: self.G[k].detach().requires_grad_(True) for k in keys}
        g = {**self.G, **var}
        fake, stats_g, _ = self._fwd("G", g, (z, fy))
        dd = {k: t.detach() for k, t in self.D.items()}
        out, _, _ = self._fwd("D", dd, (fake, fy))
        loss_g = bce(out, 1.0)
        gg = dict(zip(keys, torch.autograd.grad(loss_g, list(var.values()))))
        self.opt_g.update(self.G, gg)
        _set_stats(self.model, self.G, {k: (m.detach(), v.detach())
                                        for k, (m, v) in stats_g.items()})
        return loss_d.detach(), loss_g.detach(), gd, gg


def topology(model: dict, net: str, cuts: Sequence[Tuple[int, int]],
             device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(owners, users)`` client ids of every layer from each client's
    ``(head, tail)`` cut: client k owns layers ``[0, head)`` and
    ``[tail, n)``; the server runs ``[head, tail)`` for it."""
    n = len(layer_specs(model, net))
    out = []
    for l in range(n):
        own = [k for k, (h, t) in enumerate(cuts) if not h <= l < t]
        use = [k for k, (h, t) in enumerate(cuts) if h <= l < t]
        out.append((torch.tensor(own, dtype=torch.long, device=device),
                    torch.tensor(use, dtype=torch.long, device=device)))
    return out
