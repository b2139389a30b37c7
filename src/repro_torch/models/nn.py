"""Layers of the Table-3 cGAN and of the split LM in PyTorch (port of
``repro.models.nn``, the subset those two use).

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

The split LM's layers (``linear_*``, ``rmsnorm_*``, ``gelu``) are
single copies with the reference's layouts: a dense weight is
``[in, out]``, an RMSNorm scale ``[dim]``.

Initialisers draw on the CPU from the caller's ``torch.Generator`` and
then move to ``device``, so a seed gives the same weights on every
device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _he_normal(shape, fan_in, gen, device):
    std = math.sqrt(2.0 / max(fan_in, 1))
    return (torch.randn(shape, generator=gen) * std).to(device)


def dense_init(n: int, in_dim: int, out_dim: int, gen, device) -> Params:
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = torch.rand((n, in_dim, out_dim), generator=gen) * (2 * limit) - limit
    return {"w": w.to(device),
            "b": torch.zeros((n, out_dim), device=device)}


def linear_init(in_dim: int, out_dim: int, gen, device) -> Params:
    """A single-copy dense layer (Glorot-uniform weight, zero bias)."""
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = torch.rand((in_dim, out_dim), generator=gen) * (2 * limit) - limit
    return {"w": w.to(device), "b": torch.zeros((out_dim,), device=device)}


def rmsnorm_init(dim: int, device) -> Params:
    return {"scale": torch.ones((dim,), device=device)}


def embedding_init(n: int, vocab: int, dim: int, gen, device) -> Params:
    t = torch.randn((n, vocab, dim), generator=gen) / math.sqrt(dim)
    return {"table": t.to(device)}


def conv2d_init(n: int, in_ch: int, out_ch: int, kernel: int, gen,
                device) -> Params:
    return {"w": _he_normal((n, out_ch, in_ch, kernel, kernel),
                            in_ch * kernel * kernel, gen, device),
            "b": torch.zeros((n, out_ch), device=device)}


def convT2d_init(n: int, in_ch: int, out_ch: int, kernel: int, gen,
                 device) -> Params:
    return {"w": _he_normal((n, in_ch, out_ch, kernel, kernel),
                            in_ch * kernel * kernel, gen, device),
            "b": torch.zeros((n, out_ch), device=device)}


def batchnorm_init(n: int, ch: int, device) -> Params:
    return {"scale": torch.ones((n, ch), device=device),
            "bias": torch.zeros((n, ch), device=device),
            "mean": torch.zeros((n, ch), device=device),
            "var": torch.ones((n, ch), device=device)}


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [K, b, in] @ w [K, in, out] + b [K, out]."""
    return torch.bmm(x, p["w"]) + p["b"][:, None, :]


def linear_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] + b [out]."""
    return x @ p["w"] + p["b"]


def embedding_apply(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """table [K, V, dim], ids [K, b] -> [K, b, dim]."""
    k = torch.arange(ids.shape[0], device=ids.device)[:, None]
    return p["table"][k, ids.long()]


# ---------------------------------------------------------------------------
# conv / conv-transpose ("SAME" padding, NHWC activations)
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


def conv2d_apply(p: Params, x: torch.Tensor, *, stride: int = 1
                 ) -> torch.Tensor:
    K, _, H, W, _ = x.shape
    w = p["w"]                                          # [K, O, I, kh, kw]
    O, I, kh, kw = w.shape[1:]
    ph, pw = same_pads(H, kh, stride), same_pads(W, kw, stride)
    xg = F.pad(_to_grouped(x), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xg, w.reshape(K * O, I, kh, kw), stride=stride, groups=K)
    return _from_grouped(y, K) + p["b"][:, None, None, None, :]


def conv_transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """"SAME" padding of ``lax.conv_transpose`` on the stride-dilated
    input: (before, after), which sum to k + s - 2."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else -(-pad_len // 2)
    return before, pad_len - before


def convT2d_apply(p: Params, x: torch.Tensor, *, stride: int = 1
                  ) -> torch.Tensor:
    """``lax.conv_transpose(x, w, SAME)`` without ``transpose_kernel``:
    correlate the stride-dilated input with the HWIO kernel. The stored
    kernel is that kernel flipped in space with I/O in torch's order, so
    ``F.conv_transpose2d`` computes it once the padding is matched: its
    padding ``p`` pads ``k - 1 - p`` before, and ``output_padding``
    adds after. When JAX pads less after than before, the extra output
    rows are cropped. Output size is ``size * stride``."""
    K, _, H, W, _ = x.shape
    w = p["w"]                                          # [K, I, O, kh, kw]
    I, O, kh, kw = w.shape[1:]
    (bh, ah), (bw, aw) = conv_transpose_pads(kh, stride), \
        conv_transpose_pads(kw, stride)
    y = F.conv_transpose2d(
        _to_grouped(x), w.reshape(K * I, O, kh, kw), stride=stride,
        padding=(kh - 1 - bh, kw - 1 - bw),
        output_padding=(max(ah - bh, 0), max(aw - bw, 0)), groups=K)
    y = y[:, :, :H * stride, :W * stride]
    return _from_grouped(y, K) + p["b"][:, None, None, None, :]


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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, which ``jax.nn.gelu`` takes by default
    (PyTorch's default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")
