"""K4, flash decode: one query token per batch row against a KV cache
masked to the positions before ``min(cache_len, S)``, in float32 (port of
``repro.kernels.flash_decode``; the CUDA source is
``csrc/flash_decode.cu``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``flash_decode_ref``.

The kernel splits the cache across ``decode_splits`` blocks per (batch
row, kv head) and combines the splits in the same launch: the last block
of each (batch row, kv head) to finish combines them, counted on a
per-stream int32 counter array that the kernel leaves at 0.
"""
from __future__ import annotations

from typing import List, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mem_attention import check_attention_args
from repro_torch.kernels.ref import flash_decode_ref

# the widest GQA group (H / KV) * hd the wrapper accepts
MAX_GROUP_WIDTH = 2048
# blocks the kernel keeps resident per SM (64 KB of shared memory each)
BLOCKS_PER_SM = 3
# fewest cache rows worth a split of their own, and the most splits (the
# combining block reads every split's partial sums)
MIN_SPLIT_ROWS = 256
MAX_SPLITS = 128

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


def decode_splits(B: int, KV: int, S: int, n_sm: int) -> int:
    """How many blocks split one (batch row, kv head)'s cache: enough
    for BLOCKS_PER_SM blocks on each of ``n_sm`` SMs in one wave, but no
    split shorter than MIN_SPLIT_ROWS of the S cache rows (so a short
    cache takes one split and no combine), and at most MAX_SPLITS."""
    want = BLOCKS_PER_SM * n_sm // max(1, B * KV)
    return max(1, min(want, S // MIN_SPLIT_ROWS, MAX_SPLITS))


def split_boundary_lengths(S: int, n: int) -> List[int]:
    """Cache lengths in [1, S] that probe an n-way split of S rows: lengths
    at or below n (empty splits), ceil(S / n) * i - 1, + 0 and + 1 at the
    first two and last two boundaries, S - 7 and S. The tests and the chip
    smoke test check the kernel at these."""
    per = -(-S // n)
    near = {per * i + d for i in (1, 2, n - 1, n) for d in (-1, 0, 1)}
    return sorted(x for x in near | {1, n // 2, n - 1, n, n + 1, S - 7, S}
                  if 1 <= x <= S)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q [B, H, hd], k/v [B, S, KV, hd] float32 -> [B, H, hd].
    ``cache_len`` is a Python int or a one-element int32 tensor on the
    same device; the kernel reads the tensor itself, so a decode loop
    never waits on the host."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_decode_ref(q, k, v, cache_len)
    check_attention_args("flash_decode", q, k, v, 3)
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if (H // KV) * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"flash_decode: (H / KV) * hd = {(H // KV) * hd} "
                         f"exceeds {MAX_GROUP_WIDTH}")
    if isinstance(cache_len, torch.Tensor):
        if (cache_len.device != q.device or cache_len.dtype != torch.int32
                or cache_len.numel() != 1):
            raise ValueError("flash_decode: a cache_len tensor must be one "
                             f"int32 element on {q.device}, got "
                             f"{cache_len.dtype} {tuple(cache_len.shape)} on "
                             f"{cache_len.device}")
        len_ptr, len_val = cache_len.data_ptr(), 0
    else:
        len_ptr, len_val = None, min(int(cache_len), S)
    out = torch.empty_like(q)
    if min(B, H) == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n = decode_splits(B, KV, S, build.sm_count(q.device.index))
    if n > 1:
        cnt, ws = build.split_scratch(q.device, stream, B * KV,
                                      (2 + hd) * B * H * n)
        ws_ptr, cnt_ptr = ws.data_ptr(), cnt.data_ptr()
    else:
        ws_ptr = cnt_ptr = None
    rc = build.kernel("flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_val,
        out.data_ptr(), ws_ptr, cnt_ptr, B, S, H, KV, hd, n, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
