"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``,
the two the training path uses). The wrappers take them for tensors on
the CPU; on the card they are what each kernel is checked against."""
from __future__ import annotations

import torch


def clustered_agg_ref(weights: torch.Tensor, stacked: torch.Tensor
                      ) -> torch.Tensor:
    """out[s] = sum_k W[s, k] x[k] in float32: weights [S, K] (one
    normalized row per aggregation segment), stacked [K, ...]. Weights
    come first (matmul order ``W @ theta``)."""
    flat = stacked.reshape(stacked.shape[0], -1).float()
    out = weights.float() @ flat
    return out.reshape((weights.shape[0],) + stacked.shape[1:])


def kmeans_assign_ref(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centre assignment: x [N, D], centers [M, D] -> labels [N]
    int32, ties to the lowest index."""
    x, c = x.float(), centers.float()
    d2 = ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
          + (c * c).sum(-1)[None, :])
    return torch.argmin(d2, dim=1).to(torch.int32)
