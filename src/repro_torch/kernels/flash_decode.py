"""K4, flash decode: one query token per batch row against a KV cache
masked to the positions before ``min(cache_len, S)``, in float32 (port of
``repro.kernels.flash_decode``; the CUDA source is
``csrc/flash_decode.cu``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``flash_decode_ref``.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mem_attention import check_attention_args
from repro_torch.kernels.ref import flash_decode_ref

# (H / KV) * hd outputs per block, at most 8 per thread of 256
MAX_GROUP_WIDTH = 2048

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


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
    rc = build.kernel("flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, len_val,
        out.data_ptr(), B, S, H, KV, hd, stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
