"""K2, k-means nearest-centre assignment: ``labels[n] = argmin_m
||x[n] - c[m]||^2`` as int32, ties to the lowest index, the first NaN
distance winning as in ``jnp.argmin`` — the Lloyd assignment step of
stage-3 clustering (port of ``repro.kernels.kmeans_assign``; the CUDA
source is ``csrc/kmeans_assign.cu``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``kmeans_assign_ref``.

The kernel takes x in tiles of ROWS_PER_BLOCK rows and, when there are
too few tiles to fill the card, splits D across ``assign_splits`` blocks
per tile; the last block of each tile to finish combines the splits in
the same launch, counted on a per-stream int32 counter array that the
kernel leaves at 0, through a per-stream workspace (both kept in
``build.scratch``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import kmeans_assign_ref, kmeans_split_len

# rows of x per block and centres per pass (kRows, kMChunk in the CUDA
# source)
ROWS_PER_BLOCK = 16
CENTRES_PER_PASS = 8
# blocks per SM that one wave of the split grid aims at
BLOCKS_PER_SM = 2
# fewest columns worth a split of their own, and the most splits (the
# combining block stages every split's partials in shared memory;
# kMaxSplits)
MIN_SPLIT = 256
MAX_SPLITS = 32

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


def assign_splits(N: int, D: int, n_sm: int) -> Tuple[int, int]:
    """(split count, columns per split) for x [N, D] on ``n_sm`` SMs:
    enough splits of each row tile for BLOCKS_PER_SM blocks on every SM
    in one wave, but no split shorter than MIN_SPLIT columns and at most
    MAX_SPLITS, so a large N takes one split and no combine. Splits start
    on multiples of 4 columns; the last one runs on to D."""
    tiles = -(-N // ROWS_PER_BLOCK)
    n = max(1, min(BLOCKS_PER_SM * n_sm // tiles, D // MIN_SPLIT,
                   MAX_SPLITS))
    return n, kmeans_split_len(D, n)


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
    n, per = assign_splits(N, D, build.sm_count(x.device.index))
    if n > 1:
        tiles = -(-N // ROWS_PER_BLOCK)
        # per row tile, pass of centres and split: |c|^2 and the tile's
        # partial dots, one float per centre of the pass each
        cnt, ws = build.split_scratch(
            x.device, stream, tiles, tiles * -(-M // CENTRES_PER_PASS) * n
            * (ROWS_PER_BLOCK + 1) * CENTRES_PER_PASS)
        ws_ptr, cnt_ptr = ws.data_ptr(), cnt.data_ptr()
    else:
        ws_ptr = cnt_ptr = None
    rc = build.kernel("kmeans_assign")(
        x.data_ptr(), centers.data_ptr(), labels.data_ptr(), ws_ptr, cnt_ptr,
        N, M, D, n, per, stream)
    if rc != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return labels
