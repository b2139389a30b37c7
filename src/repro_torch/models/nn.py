"""Layers of the Table-3 cGAN, the evaluation CNN and the split LM in
PyTorch, and the tree helpers the baselines use (port of
``repro.models.nn``, the subset those use).

Parameters are plain nested dicts of tensors. Every parameter carries a
leading copy axis ``K`` and every activation a leading ``[K, b]`` pair:
``K`` independent clients (each with its own weights) run as one call,
which is what the reference gets from ``jax.vmap``. Convolutions do it
as one grouped convolution with ``groups=K``.

Layouts: activations are NHWC, as in the reference. Conv kernels are
kept as ``[K, O, I, kh, kw]``; transposed-conv kernels as
``[K, I, O, kh, kw]`` already flipped in space, i.e. ready for
``F.conv_transpose2d``. ``repro_torch.bridge`` converts from and to
the reference's HWIO kernels.

The LM layers (``linear_*``, ``rmsnorm_*``, ``layernorm_*``,
``embedding_table_init``/``embedding_attend``, ``conv1d_*``, the gated
activations) are single copies with the reference's layouts: a dense
weight is ``[in, out]``, a norm scale ``[dim]``, an embedding table
``[vocab, dim]``, a conv1d kernel ``[k, in, out]``. Where the reference
asks for a float32 result of a low-precision product
(``preferred_element_type=jnp.float32``), ``mm_f32`` gives it: the
products of bf16 values are exact in float32, so casting the operands
and multiplying in float32 is that product.

The GAN's initialisers draw on the CPU from the caller's
``torch.Generator`` and then move to ``device``, so a seed gives the
same weights on every device. ``normal_init`` draws on the generator's
own device, so a generator on the card fills a full-size LM there.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _he_normal(shape, fan_in, gen, device):
    std = math.sqrt(2.0 / max(fan_in, 1))
    return (torch.randn(shape, generator=gen) * std).to(device)


def _with_bias(w: torch.Tensor, lead: Tuple[int, ...], out_ch: int,
               use_bias: bool, device, dtype) -> Params:
    """``{"w"}`` as ``dtype`` on ``device``, with a zero bias
    ``[*lead, out_ch]`` unless ``use_bias`` is False."""
    p = {"w": w.to(device=device, dtype=dtype)}
    if use_bias:
        p["b"] = torch.zeros(lead + (out_ch,), device=device, dtype=dtype)
    return p


def dense_init(n: int, in_dim: int, out_dim: int, gen, device, *,
               use_bias: bool = True, dtype=torch.float32) -> Params:
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = torch.rand((n, in_dim, out_dim), generator=gen) * (2 * limit) - limit
    return _with_bias(w, (n,), out_dim, use_bias, device, dtype)


def linear_init(in_dim: int, out_dim: int, gen, device, *,
                dtype=torch.float32) -> Params:
    """A single-copy dense layer (Glorot-uniform weight, zero bias)."""
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = torch.rand((in_dim, out_dim), generator=gen) * (2 * limit) - limit
    return _with_bias(w, (), out_dim, True, device, dtype)


def rmsnorm_init(dim: int, device, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((dim,), device=device, dtype=dtype)}


def layernorm_init(dim: int, device, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((dim,), device=device, dtype=dtype),
            "bias": torch.zeros((dim,), device=device, dtype=dtype)}


def normal_init(shape, std: float, gen, device, dtype=torch.float32
                ) -> torch.Tensor:
    """``std`` times standard normal draws from ``gen`` (on its own
    device), as ``dtype`` on ``device``."""
    x = torch.randn(shape, generator=gen, device=gen.device) * std
    return x.to(device=device, dtype=dtype)


def embedding_table_init(vocab: int, dim: int, gen, device,
                         dtype=torch.float32) -> Params:
    """One LM embedding table ``[vocab, dim]``, std 1/sqrt(dim)."""
    return {"table": normal_init((vocab, dim), 1.0 / math.sqrt(dim), gen,
                                 device, dtype)}


def conv1d_init(in_ch: int, out_ch: int, kernel: int, gen, device, *,
                use_bias: bool = True, dtype=torch.float32) -> Params:
    """He-normal ``[kernel, in, out]`` kernel (the reference's TIO)."""
    p = {"w": normal_init((kernel, in_ch, out_ch),
                          math.sqrt(2.0 / (kernel * in_ch)), gen, device,
                          dtype)}
    if use_bias:
        p["b"] = torch.zeros((out_ch,), device=device, dtype=dtype)
    return p


def embedding_init(n: int, vocab: int, dim: int, gen, device, *,
                   dtype=torch.float32) -> Params:
    t = torch.randn((n, vocab, dim), generator=gen) / math.sqrt(dim)
    return {"table": t.to(device=device, dtype=dtype)}


def conv2d_init(n: int, in_ch: int, out_ch: int, kernel: int, gen,
                device, *, use_bias: bool = True, dtype=torch.float32
                ) -> Params:
    w = _he_normal((n, out_ch, in_ch, kernel, kernel),
                   in_ch * kernel * kernel, gen, "cpu")
    return _with_bias(w, (n,), out_ch, use_bias, device, dtype)


def convT2d_init(n: int, in_ch: int, out_ch: int, kernel: int, gen,
                 device, *, use_bias: bool = True, dtype=torch.float32
                 ) -> Params:
    w = _he_normal((n, in_ch, out_ch, kernel, kernel),
                   in_ch * kernel * kernel, gen, "cpu")
    return _with_bias(w, (n,), out_ch, use_bias, device, dtype)


def batchnorm_init(n: int, ch: int, device, dtype=torch.float32) -> Params:
    """Scale and shift as ``dtype``; the running statistics are always
    float32, as in the reference."""
    return {"scale": torch.ones((n, ch), device=device, dtype=dtype),
            "bias": torch.zeros((n, ch), device=device, dtype=dtype),
            "mean": torch.zeros((n, ch), device=device),
            "var": torch.ones((n, ch), device=device)}


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [K, b, in] @ w [K, in, out] (+ b [K, out]), the weight cast to
    ``x``'s dtype as the reference casts it."""
    y = torch.bmm(x, p["w"].to(x.dtype))
    return y + p["b"][:, None, :] if "b" in p else y


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] + b [out]."""
    return x @ p["w"].to(x.dtype) + p["b"]


def embedding_apply(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """table [K, V, dim], ids [K, b] -> [K, b, dim]."""
    k = torch.arange(ids.shape[0], device=ids.device)[:, None]
    return p["table"][k, ids.long()]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result, whatever the operands' dtype."""
    return torch.matmul(a.float(), b.float())


def embedding_attend(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: float32 logits ``x @ table.T``."""
    return mm_f32(x, p["table"].t())


def conv1d_apply(p: Params, x: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """x [B, T, C] -> [B, T', O]: XLA's "SAME" (or "VALID") conv1d,
    computed in float32 and cast back to ``x``'s dtype."""
    w = p["w"].float().permute(2, 1, 0)                 # [O, I, k]
    xt = x.float().transpose(1, 2)                      # [B, C, T]
    if padding == "SAME":
        xt = F.pad(xt, same_pads(x.shape[1], w.shape[-1], stride))
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}")
    y = F.conv1d(xt, w, stride=stride).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# conv / conv-transpose (NHWC activations; "SAME", "VALID" or explicit
# ((lo, hi), (lo, hi)) padding with lax's semantics)
# ---------------------------------------------------------------------------

def _to_grouped(x: torch.Tensor) -> torch.Tensor:
    """[K, b, H, W, C] -> [b, K*C, H, W] (client k owns channel group k)."""
    K, b, H, W, C = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, K * C, H, W)


def _from_grouped(y: torch.Tensor, K: int) -> torch.Tensor:
    """[b, K*O, H, W] -> [K, b, H, W, O]."""
    b, KO, H, W = y.shape
    return y.reshape(b, K, KO // K, H, W).permute(1, 0, 3, 4, 2)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of a strided conv: out = ceil(size / s) and
    the odd pixel goes after, e.g. (1, 2) for 7 -> 4 at k=4, s=2."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _explicit_pads(padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def _add_bias(p: Params, y: torch.Tensor) -> torch.Tensor:
    """A grouped layer's [K, b, H, W, O] output plus its bias, if any."""
    return y + p["b"][:, None, None, None, :] if "b" in p else y


def conv2d_apply(p: Params, x: torch.Tensor, *, stride: int = 1,
                 padding="SAME") -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (stride, stride), padding)`` per
    client: "SAME", "VALID", or explicit ``((lo, hi), (lo, hi))`` pixels
    per spatial axis (a negative one crops)."""
    K, _, H, W, _ = x.shape
    w = p["w"].to(x.dtype)                              # [K, O, I, kh, kw]
    O, I, kh, kw = w.shape[1:]
    if padding == "SAME":
        ph, pw = same_pads(H, kh, stride), same_pads(W, kw, stride)
    elif padding == "VALID":
        ph, pw = (0, 0), (0, 0)
    else:
        ph, pw = _explicit_pads(padding)
    xg = F.pad(_to_grouped(x), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xg, w.reshape(K * O, I, kh, kw), stride=stride, groups=K)
    return _add_bias(p, _from_grouped(y, K))


def conv_transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """"SAME" padding of ``lax.conv_transpose`` on the stride-dilated
    input: (before, after), which sum to k + s - 2."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else -(-pad_len // 2)
    return before, pad_len - before


def conv_transpose_valid_pads(k: int, s: int) -> Tuple[int, int]:
    """"VALID" padding of ``lax.conv_transpose`` on the stride-dilated
    input: (before, after), which sum to k + s - 2 + max(k - s, 0)."""
    pad_len = k + s - 2 + max(k - s, 0)
    return k - 1, pad_len - (k - 1)


def convT2d_apply(p: Params, x: torch.Tensor, *, stride: int = 1,
                  padding="SAME") -> torch.Tensor:
    """``lax.conv_transpose(x, w, padding)`` without
    ``transpose_kernel``: correlate the stride-dilated input, padded by
    ``padding`` ("SAME", "VALID", or explicit ``((lo, hi), (lo, hi))``
    pixels of the dilated input), with the HWIO kernel. The stored
    kernel is that kernel flipped in space with I/O in torch's order, so
    ``F.conv_transpose2d`` computes it once the padding is matched: at
    padding 0 it pads ``k - 1`` on both sides of the dilated input, and
    "SAME" sets its ``padding`` ``p`` (``k - 1 - p`` before) and
    ``output_padding`` (added after), cropping the extra rows when JAX
    pads less after than before (output size ``size * stride``). Any
    other padding pads or crops (negative) that full output by ``lo -
    (k - 1)`` before and ``hi - (k - 1)`` after."""
    K, _, H, W, _ = x.shape
    w = p["w"].to(x.dtype)                              # [K, I, O, kh, kw]
    I, O, kh, kw = w.shape[1:]
    wg = w.reshape(K * I, O, kh, kw)
    if padding == "SAME":
        (bh, ah), (bw, aw) = conv_transpose_pads(kh, stride), \
            conv_transpose_pads(kw, stride)
        y = F.conv_transpose2d(
            _to_grouped(x), wg, stride=stride,
            padding=(kh - 1 - bh, kw - 1 - bw),
            output_padding=(max(ah - bh, 0), max(aw - bw, 0)), groups=K)
        y = y[:, :, :H * stride, :W * stride]
    else:
        if padding == "VALID":
            ph = conv_transpose_valid_pads(kh, stride)
            pw = conv_transpose_valid_pads(kw, stride)
        else:
            ph, pw = _explicit_pads(padding)
        y = F.conv_transpose2d(_to_grouped(x), wg, stride=stride, groups=K)
        y = F.pad(y, (pw[0] - (kw - 1), pw[1] - (kw - 1),
                      ph[0] - (kh - 1), ph[1] - (kh - 1)))
    return _add_bias(p, _from_grouped(y, K))


# ---------------------------------------------------------------------------
# normalization / activation
# ---------------------------------------------------------------------------

def batchnorm_apply(p: Params, x: torch.Tensor, *, train: bool,
                    momentum: float = 0.9, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, Params]:
    """Per-copy BatchNorm over every axis but the copy axis and the
    last: returns (y, updated params). The running statistics keep
    ``momentum`` of the old value and take the biased variance, as the
    reference does (``nn.BatchNorm2d`` does neither)."""
    dims = tuple(range(1, x.ndim - 1))
    bshape = (x.shape[0],) + (1,) * len(dims) + (x.shape[-1],)
    if train:
        mean = x.mean(dims)
        var = x.var(dims, correction=0)
        new_p = dict(p)
        new_p["mean"] = (momentum * p["mean"]
                         + (1 - momentum) * mean.detach())
        new_p["var"] = momentum * p["var"] + (1 - momentum) * var.detach()
    else:
        mean, var = p["mean"], p["var"]
        new_p = p
    inv = torch.rsqrt(var + eps)
    y = ((x - mean.reshape(bshape)) * inv.reshape(bshape)
         * p["scale"].reshape(bshape) + p["bias"].reshape(bshape))
    return y, new_p


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def rmsnorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale over the last axis, in float32."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias over the last axis,
    with float32 statistics (biased variance)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, which ``jax.nn.gelu`` takes by default
    (PyTorch's default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def geglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return gelu(gate) * x


def swiglu(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * x


# ---------------------------------------------------------------------------
# tree helpers over nested dicts of tensors (``repro_torch.tree`` order)
# ---------------------------------------------------------------------------

def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_weighted_sum(stacked, weights: torch.Tensor):
    """stacked: tree with leading client axis K; weights: [K]. Sums in
    float32 and casts back to each leaf's dtype."""
    w = weights.to(torch.float32)
    return tree_map(lambda x: torch.einsum("k,k...->...", w, x.float())
                    .to(x.dtype), stacked)


def tree_size(tree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(int(x.numel() * x.element_size()) for x in tree_leaves(tree))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in tree_leaves(tree)]).sum())
