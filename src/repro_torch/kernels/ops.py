"""Public entry points of the kernels (port of ``repro.kernels.ops``).
The federation round and the clustering stage call the first three (the
legacy per-(layer, cluster) oracle ``weighted_agg``), the split-serving
LM the attention pair."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import mem_attention as _ma
from repro_torch.kernels import weighted_agg as _wa


def weighted_agg(stacked: torch.Tensor, weights: torch.Tensor
                 ) -> torch.Tensor:
    """out = sum_k w[k] * stacked[k, ...] (any trailing shape), in
    float32, returned in stacked's dtype: K1's S = 1 case."""
    flat = stacked.reshape(stacked.shape[0], -1)
    return _wa.weighted_agg_flat(flat, weights).reshape(stacked.shape[1:])


def clustered_agg(weights: torch.Tensor, stacked: torch.Tensor
                  ) -> torch.Tensor:
    """Multi-output clustered aggregation: weights [S, K] rows are
    normalized (layer, cluster) segments; out[s] = sum_k W[s, k] *
    stacked[k, ...] in float32, any trailing shape. Weights come first
    (matmul order ``W @ theta``)."""
    flat = stacked.reshape(stacked.shape[0], -1)
    out = _wa.clustered_agg_flat(weights, flat)
    return out.reshape((weights.shape[0],) + stacked.shape[1:])


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [N, D], centers [M, D] -> labels [N] int32."""
    return _km.kmeans_assign(x, centers)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q [B, H, hd], k/v [B, S, KV, hd], cache_len a scalar (Python int
    or one-element int32 tensor) -> [B, H, hd]."""
    if isinstance(cache_len, torch.Tensor) and q.device.type == "cuda":
        cache_len = cache_len.to(device=q.device, dtype=torch.int32)
    return _fd.flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                            cache_len)


def mem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lens: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Memory-efficient prefill attention: q [B, S, H, hd], k/v [B, S, KV,
    hd], lens [B] int32 -> [B, S, H, hd], never building the [S, S]
    scores on the card."""
    return _ma.mem_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             lens, causal=causal)
