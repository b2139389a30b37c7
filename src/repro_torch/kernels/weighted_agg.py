"""K1, clustered federated aggregation: ``agg[S, D] = W[S, K] @ theta[K, D]``
in float32 — every (layer, cluster) aggregate of an Eq.-16 round in one
launch per network (port of ``repro.kernels.weighted_agg``; the CUDA
source is ``csrc/clustered_agg.cu``). ``weighted_agg_flat`` is its S = 1
case, one weighted average over the clients.

``theta`` may be row-strided (``stride(1) == 1``, ``stride(0) >= D``):
the federation plan pads its rows to a multiple of 32 floats, so every
row starts on a 16-byte boundary and the kernel copies it 16 bytes at a
time; other rows are copied 4 bytes at a time. Any S and K are taken.
The result is a ``[S, D]`` view of a buffer whose rows are padded to a
multiple of 4 floats.

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``clustered_agg_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import clustered_agg_ref

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


def _round4(n: int) -> int:
    return -(-n // 4) * 4


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
    S, K = weights.shape
    D = theta.shape[1]
    if min(S, K, D) == 0:
        raise ValueError(f"clustered_agg_flat: empty shape S={S} K={K} D={D}")
    if not weights.is_contiguous():
        raise ValueError("clustered_agg_flat takes contiguous weights")
    if (D > 1 and theta.stride(1) != 1) or (K > 1 and theta.stride(0) < D):
        raise ValueError(f"clustered_agg_flat takes theta with contiguous "
                         f"rows, got strides {theta.stride()} at shape "
                         f"{tuple(theta.shape)}")
    ld = theta.stride(0) if K > 1 else _round4(D)
    buf = torch.empty((S, _round4(D)), dtype=torch.float32,
                      device=theta.device)
    aligned = int(ld % 4 == 0 and theta.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = build.kernel("clustered_agg")(
        weights.data_ptr(), theta.data_ptr(), buf.data_ptr(), S, K, D, ld,
        buf.stride(0), aligned, stream)
    if rc != 0:
        raise RuntimeError(f"clustered_agg kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return buf[:, :D]


def weighted_agg_flat(stacked_flat: torch.Tensor, weights: torch.Tensor
                      ) -> torch.Tensor:
    """stacked_flat [K, D] -> [D]: ``sum_k w[k] * stacked_flat[k]``, K1
    with ``W = weights[None]`` in float32, cast back to the input's
    dtype."""
    out = clustered_agg_flat(weights.reshape(1, -1).float().contiguous(),
                             stacked_flat.float())
    return out[0].to(stacked_flat.dtype)
