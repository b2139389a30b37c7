"""K1, clustered federated aggregation: ``agg[S, D] = W[S, K] @ theta[K, D]``
in float32 — every (layer, cluster) aggregate of an Eq.-16 round in one
launch per network (port of ``repro.kernels.weighted_agg``; the CUDA
source is ``csrc/clustered_agg.cu``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``clustered_agg_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import clustered_agg_ref

# shared memory a block may use on Hopper (227 KB)
_MAX_SMEM = 232448

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


def clustered_agg_flat(weights: torch.Tensor, theta: torch.Tensor
                       ) -> torch.Tensor:
    """weights [S, K] @ theta [K, D] -> [S, D] float32."""
    global launches
    if weights.device.type == "cpu" and theta.device.type == "cpu":
        return clustered_agg_ref(weights, theta)
    if weights.device.type != "cuda" or theta.device != weights.device:
        raise ValueError(f"clustered_agg_flat: weights on {weights.device}, "
                         f"theta on {theta.device}; both must be on one "
                         "CUDA device (or both on the CPU)")
    if weights.dtype != torch.float32 or theta.dtype != torch.float32:
        raise TypeError("clustered_agg_flat takes float32 weights and theta, "
                        f"got {weights.dtype} and {theta.dtype}")
    if weights.ndim != 2 or theta.ndim != 2 or weights.shape[1] != theta.shape[0]:
        raise ValueError(f"clustered_agg_flat: shapes {tuple(weights.shape)} "
                         f"@ {tuple(theta.shape)} do not contract")
    if not (weights.is_contiguous() and theta.is_contiguous()):
        raise ValueError("clustered_agg_flat takes contiguous tensors")
    S, K = weights.shape
    D = theta.shape[1]
    if min(S, K, D) == 0:
        raise ValueError(f"clustered_agg_flat: empty shape S={S} K={K} D={D}")
    if S * K * 4 > _MAX_SMEM:
        raise ValueError(f"clustered_agg_flat: W [{S}, {K}] exceeds the "
                         "shared memory of one block")
    out = torch.empty((S, D), dtype=torch.float32, device=theta.device)
    vec4 = int(D % 4 == 0 and theta.data_ptr() % 16 == 0
               and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = build.kernel("clustered_agg")(
        weights.data_ptr(), theta.data_ptr(), out.data_ptr(), S, K, D, vec4,
        stream)
    if rc != 0:
        raise RuntimeError(f"clustered_agg kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
