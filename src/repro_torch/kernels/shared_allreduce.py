"""The sum of a float32 vector over the ranks of a process group whose
processes share one card, as a hand-written kernel that a CUDA graph can
capture (the CUDA source is ``csrc/shared_allreduce.cu``).

It replaces no Pallas kernel: it stands in for the ``psum`` that XLA
places inside the reference's fused epoch under ``fed_mesh``
(``repro.core.huscf.make_epoch_fn``), where the port's client-sharded
step sums its server BatchNorm statistics, server gradients and losses
over the ranks (``launch.mesh.all_reduce_sum``). Gloo stages each call
through the host, which a captured graph cannot run, and NCCL refuses
two ranks on one device; ranks that share a card map each other's
buffers through CUDA IPC instead, and the kernel sums them on the
device.

``SharedAllReduce(group, device)`` is one group's: it allocates this
rank's buffer with ``cudaMalloc`` (outside torch's caching allocator, so
that its IPC handle covers exactly it), exchanges the handles over the
group (``all_gather_object``; gloo) and maps every peer's. The buffers
are sized at the first eager call of a message that does not fit (the
eager warm-up step of a fused epoch sizes them for the step's largest
message, the packed server gradients of one net), with a new exchange;
inside a capture a message that does not fit raises. ``release()`` (a
collective: every rank calls it) unmaps and frees them, with the graphs
that baked their addresses in.

Every rank adds the ranks' partials in rank order 0..n-1 in float32, so
all ranks get the same bits, equal to ``plain_all_reduce``: the plain
version, ``all_gather`` of the partials over the group and the same
rank-order sum (``rank_order_sum``). A CPU tensor takes it; a CUDA
tensor launches the kernel, or the wrapper raises (a dtype other than
float32, ranks on more than one device, a message past the buffers
during a capture).

Waits inside the kernel are bounded (``TIMEOUT_S``, read when the
object is built): a peer that does not arrive makes the kernel write
(1, rank, peer, call site, sequence) into ``error`` and end, and every
later call on this rank returns at once; ``check_error`` raises on the
word. The trainer reads it at its epoch's one readback.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels import build

# kernel launches since the last reset (eager calls and captures; a
# graph's replays launch the captured kernels without a call here, and
# ``executions`` counts them on the device)
launches = 0

MAX_RANKS = 8                 # kMaxRanks in the CUDA source
HANDLE_BYTES = 64             # sizeof(cudaIpcMemHandle_t)
TIMEOUT_S = 60.0
# slots grow in steps of this many floats (16-byte aligned at any size)
_GRAIN = 1024
_HEADER_ALIGN = 256


def rank_order_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ... `` in rank order, in float32: the sum
    every rank of the kernel computes."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc.add_(p)
    return acc


def plain_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The plain version: every rank's ``x`` gathered over ``group`` and
    summed in rank order (``rank_order_sum``), written into ``x``."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    x.copy_(rank_order_sum(parts))
    return x


def check_error(words: Sequence[int]) -> None:
    """Raise on a kernel's error word (1, rank, peer, call site,
    sequence); zeros mean no wait timed out."""
    if int(words[0]) != 0:
        _, rank, peer, site, seq = (int(w) for w in words[:5])
        raise RuntimeError(
            f"shared all-reduce: rank {rank} waited past its timeout for "
            f"rank {peer} at its call {site} (sequence {seq}); the ranks "
            "did not run the same collectives")


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"shared all-reduce: {what} failed with CUDA "
                           f"error {rc}")


class SharedAllReduce:
    """The kernel's buffers for one process group (module docstring).
    ``sizes`` counts the messages reduced by size."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.ranks = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.timeout_ns = int(TIMEOUT_S * 1e9)
        self.cap = 0
        self.sizes: Counter = Counter()
        self._own: Optional[int] = None
        self._peers: List[int] = []
        self._site = 0
        self._runs = 0          # runs on buffers since released
        if self.device.type != "cuda":
            return
        if self.ranks > MAX_RANKS:
            raise ValueError(f"shared all-reduce: {self.ranks} ranks, at "
                             f"most {MAX_RANKS}")
        index = torch.cuda.current_device() if self.device.index is None \
            else self.device.index
        self.device = torch.device("cuda", index)
        where: List[Optional[str]] = [None] * self.ranks
        dist.all_gather_object(where, _card_id(index), group=self.group)
        if len(set(where)) != 1:
            raise ValueError(f"shared all-reduce: the group's ranks are on "
                             f"{len(set(where))} cards ({where}); it sums "
                             "between processes that share one card")
        self.blocks = build.sm_count(index)
        # this rank's own words: the blocks' sequence counters and the
        # error word (torch tensors: no peer reads them)
        self.seq = torch.zeros(self.blocks, dtype=torch.int32,
                               device=self.device)
        self.error = torch.zeros(5, dtype=torch.int32, device=self.device)

    # -- buffers -------------------------------------------------------------
    def _header_bytes(self) -> int:
        b = 2 * self.blocks * 4              # flags[2][blocks]
        return -(-b // _HEADER_ALIGN) * _HEADER_ALIGN

    def _grow(self, n: int) -> None:
        """Buffers of at least ``n`` floats per slot on every rank (a
        collective: every rank grows at the same call)."""
        lib = build.library("shared_allreduce")
        cap = -(-n // _GRAIN) * _GRAIN
        self.release()
        own = ctypes.c_void_p()
        _check(lib["sar_alloc"](self.device.index,
                                self._header_bytes() + 2 * cap * 4,
                                ctypes.byref(own)), "cudaMalloc")
        handle = ctypes.create_string_buffer(HANDLE_BYTES)
        _check(lib["sar_ipc_handle"](own, handle), "cudaIpcGetMemHandle")
        handles: List[Optional[bytes]] = [None] * self.ranks
        dist.all_gather_object(handles, handle.raw, group=self.group)
        peers = []
        for q, h in enumerate(handles):
            if q == self.rank:
                peers.append(own.value)
                continue
            ptr = ctypes.c_void_p()
            buf = ctypes.create_string_buffer(h, HANDLE_BYTES)
            _check(lib["sar_ipc_open"](self.device.index, buf,
                                       ctypes.byref(ptr)),
                   f"cudaIpcOpenMemHandle of rank {q}'s buffer")
            peers.append(ptr.value)
        self.seq.zero_()                     # the flags start at 0 too
        self._own, self._peers, self.cap = own.value, peers, cap

    def release(self) -> None:
        """Unmap the peers' buffers and free this rank's (a collective:
        every rank's kernels have finished before any buffer goes)."""
        if self._own is None:
            return
        lib = build.library("shared_allreduce")
        torch.cuda.synchronize(self.device)
        self._runs += int(self.seq[0])
        dist.barrier(group=self.group)
        for q, ptr in enumerate(self._peers):
            if q != self.rank:
                _check(lib["sar_ipc_close"](self.device.index,
                                            ctypes.c_void_p(ptr)),
                       "cudaIpcCloseMemHandle")
        _check(lib["sar_free"](self.device.index, ctypes.c_void_p(self._own)),
               "cudaFree")
        self._own, self._peers, self.cap = None, [], 0

    # -- the sum -------------------------------------------------------------
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` (contiguous float32) over the group in place: the
        kernel on the card, the plain version on the CPU."""
        global launches
        self.sizes[x.numel()] += 1
        if x.device.type == "cpu":
            return plain_all_reduce(x, self.group)
        if x.dtype != torch.float32:
            raise TypeError(f"shared all-reduce takes float32, got "
                            f"{x.dtype}")
        if x.device != self.device:
            raise ValueError(f"shared all-reduce: a tensor on {x.device}, the "
                             f"buffers on {self.device}")
        if not x.is_contiguous():
            raise ValueError("shared all-reduce takes a contiguous tensor")
        n = x.numel()
        if n == 0:
            return x
        if n > self.cap:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"shared all-reduce: a message of {n} floats outgrows "
                    f"the buffers ({self.cap} floats) during a capture; the "
                    "eager warm-up sizes them")
            self._grow(n)
        lib = build.library("shared_allreduce")
        hdr = self._header_bytes()
        slots = (ctypes.c_void_p * MAX_RANKS)(*[p + hdr for p in self._peers])
        flags = (ctypes.c_void_p * MAX_RANKS)(*self._peers)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = lib["sar_all_reduce_f32"](
            x.data_ptr(), n, slots, flags, self.seq.data_ptr(),
            self.error.data_ptr(),
            self.ranks, self.rank, self.blocks, self.cap, self._site,
            self.timeout_ns, int(x.data_ptr() % 16 == 0), stream)
        _check(rc, "the kernel launch")
        self._site += 1
        launches += 1
        return x

    def executions(self) -> int:
        """Calls the kernel has run on this rank, replays included
        (block 0's sequence counter, kept across regrown buffers; a host
        read)."""
        return self._runs + (int(self.seq[0]) if self._own is not None
                             else 0)


def _card_id(index: int) -> str:
    """What names a card across processes: its UUID (device indices
    differ between processes with other visible devices)."""
    props = torch.cuda.get_device_properties(index)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"{props.name}:{index}"
