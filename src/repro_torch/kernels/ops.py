"""Public entry points of the kernels (port of ``repro.kernels.ops``).
The federation round and the clustering stage call these."""
from __future__ import annotations

import torch

from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import weighted_agg as _wa


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
