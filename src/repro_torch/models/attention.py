"""Attention pieces of the split LM (port of ``repro.models.attention``,
the subset ``launch.serve_split`` uses): RoPE and the GQA projections.

Layouts are the reference's: ``wq/wk/wv [d, n, hd]``, ``wo [n, hd, d]``;
activations ``x [B, S, d]``, heads ``[B, S, N, hd]``. The attention
itself is ``kernels.ops.mem_attention`` / ``flash_decode``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, N, hd]; positions [B, S] or [S]. Half-split rotation:
    the first and second halves of ``hd`` are the pair's two parts (not
    interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # [B, S, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def attn_init(d_model: int, n_heads: int, n_kv: int, head_dim: int, gen,
              device) -> Dict[str, torch.Tensor]:
    """Normal weights with std 1/sqrt(d_model), and 1/sqrt(2) of that for
    the output projection; drawn on the CPU from ``gen``."""
    std = 1.0 / math.sqrt(d_model)

    def normal(shape, s):
        return (torch.randn(shape, generator=gen) * s).to(device)
    return {"wq": normal((d_model, n_heads, head_dim), std),
            "wk": normal((d_model, n_kv, head_dim), std),
            "wv": normal((d_model, n_kv, head_dim), std),
            "wo": normal((n_heads, head_dim, d_model), std / math.sqrt(2.0))}


def qkv_proj(p: Dict[str, torch.Tensor], x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"])
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"])
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"])
    return q, k, v


def out_proj(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(o.dtype))
