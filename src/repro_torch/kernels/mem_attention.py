"""K3, memory-efficient prefill attention: causal or full GQA attention
over a prompt with a valid length per batch row, in float32, without the
[S, S] scores (port of ``repro.kernels.mem_attention``; the CUDA source
is ``csrc/mem_attention.cu``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises.
A CPU tensor takes the plain version, ``mem_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mem_attention_ref

HEAD_DIMS = (8, 16, 32, 64, 128, 256)

# kernel launches since the last reset (the chip smoke test reads it)
launches = 0


def check_attention_args(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, q_ndim: int) -> None:
    """What the attention kernels take: float32, contiguous, 16-byte
    aligned tensors on one CUDA device, a head dim in ``HEAD_DIMS``, H a
    multiple of KV."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}; all must be on one CUDA device (or "
                         "all on the CPU)")
    if not all(t.dtype == torch.float32 for t in (q, k, v)):
        raise TypeError(f"{name} takes float32 q, k, v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.ndim != q_ndim or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    hd, H, KV = q.shape[-1], q.shape[-2], k.shape[2]
    if k.shape[0] != q.shape[0] or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (H must be a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} is not one of {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} takes 16-byte aligned tensors (the "
                         "kernel copies 16 bytes at a time)")


def mem_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lens: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """q [B, S, H, hd], k/v [B, S, KV, hd] float32, lens [B] int32 on the
    same device -> [B, S, H, hd]. Rows at or past their length are
    garbage by contract, as in the reference."""
    global launches
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return mem_attention_ref(q, k, v, lens, causal=causal)
    check_attention_args("mem_attention", q, k, v, 4)
    B, S, H, hd = q.shape
    if k.shape[1] != S:
        raise ValueError(f"mem_attention: q has {S} rows, k/v {k.shape[1]}")
    if (lens.device != q.device or lens.dtype != torch.int32
            or tuple(lens.shape) != (B,) or not lens.is_contiguous()):
        raise ValueError(f"mem_attention: lens must be a contiguous int32 "
                         f"[{B}] tensor on {q.device}, got {lens.dtype} "
                         f"{tuple(lens.shape)} on {lens.device}")
    out = torch.empty_like(q)
    if min(B, S, H) == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = build.kernel("mem_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, S, H, k.shape[2], hd, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"mem_attention kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
