"""K2, k-means nearest-centre assignment: ``labels[n] = argmin_m
||x[n] - c[m]||^2`` as int32, ties to the lowest index — the Lloyd
assignment step of stage-3 clustering (port of
``repro.kernels.kmeans_assign``; the CUDA source is
``csrc/kmeans_assign.cu``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``kmeans_assign_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import kmeans_assign_ref

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x [N, D], centers [M, D] float32 -> labels [N] int32."""
    global launches
    if x.device.type == "cpu" and centers.device.type == "cpu":
        return kmeans_assign_ref(x, centers)
    if x.device.type != "cuda" or centers.device != x.device:
        raise ValueError(f"kmeans_assign: x on {x.device}, centers on "
                         f"{centers.device}; both must be on one CUDA "
                         "device (or both on the CPU)")
    if x.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("kmeans_assign takes float32 x and centers, got "
                        f"{x.dtype} and {centers.dtype}")
    if x.ndim != 2 or centers.ndim != 2 or x.shape[1] != centers.shape[1]:
        raise ValueError(f"kmeans_assign: shapes {tuple(x.shape)} and "
                         f"{tuple(centers.shape)} do not match")
    if not (x.is_contiguous() and centers.is_contiguous()):
        raise ValueError("kmeans_assign takes contiguous tensors")
    N, D = x.shape
    M = centers.shape[0]
    if min(N, M, D) == 0:
        raise ValueError(f"kmeans_assign: empty shape N={N} M={M} D={D}")
    labels = torch.empty((N,), dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.kernel("kmeans_assign")(
        x.data_ptr(), centers.data_ptr(), labels.data_ptr(), N, M, D, stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return labels
