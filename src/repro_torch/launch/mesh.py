"""Meshes of ranks on ``torch.distributed`` (port of ``repro.launch.mesh``).

The port runs the reference's ``shard_map`` + ``psum`` as SPMD ranks:
every rank is a process that runs the same program on its own tensors,
its share of a sharded computation is rank-local code, and a ``psum``
becomes ``all_reduce``. A mesh is a ``torch.distributed``
``DeviceMesh`` over the ranks of the default process group; its axis
names are the reference's (``data``; ``pod``, ``data``, ``model`` on the
production meshes), so ``sharding.policy`` reads it as it reads a JAX
mesh.

``run_ranks(n, fn, *args)`` spawns ``n`` ranks and runs ``fn(*args)`` in
each (the counterpart of the reference's forced host devices, which its
tests use to build meshes of 1-8 devices in one process). The backend
is picked explicitly and logged: NCCL when every rank has a GPU of its
own; gloo on the CPU and when ranks share a GPU, since NCCL refuses two
ranks on one device. Only ``all_reduce``, ``all_gather`` and
``broadcast`` are used, which both backends take on CUDA tensors (gloo
stages them through the host).

The collectives of the client-sharded training step: ``reduce_sum``
(``all_reduce_sum`` as an autograd function whose backward is again a
sum over the ranks: the server's BatchNorm statistics, float64 sums
added in rank order from float32 words),
``all_reduce_flat`` (the server's gradients, one call per net),
``all_gather_rows`` (per-group row blocks made whole: the EMA before a
round) and ``gather_state`` / ``keep_rows``, which turn a rank's state
into the whole state and back. Each is a no-op, bit for bit, without a
mesh or on a 1-rank mesh; ``calls`` counts what each issues.

Inside a client-sharded step's fused epoch (``graph_collectives``, which
the trainer enters around its warm-up, captures and replays) the
all-reduces take the route ``graph_route`` picks: between ranks that
share one card the shared all-reduce kernel
(``kernels.shared_allreduce``: no host, capturable); with one GPU per
rank NCCL's ``all_reduce``, which a CUDA graph captures; on the CPU the
plain rank-order sum (``plain_all_reduce``), the card's arithmetic.
Gloo ranks on several cards have no capturable route and raise. Outside
such an epoch (the per-step loop, rounds, checkpoints) every call goes
to the backend's own ``all_reduce``.

``make_federation_mesh(n)`` is the 1-D ``("data",)`` mesh over the
first ``n`` ranks of the process group. In a process without one, a
1-rank mesh starts a world of one rank on an in-process store, so that
``mesh=`` with one rank works anywhere and takes the unsharded path.

The hardware constants are one NVIDIA H100 SXM5 80GB's at its 700 W
power limit (NVIDIA's data sheet, dense rates).
"""
from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from collections import Counter
from queue import Empty
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels.shared_allreduce import SharedAllReduce
from repro_torch.sharding.policy import data_axes, row_block, shard_index

# one NVIDIA H100 SXM5 80GB at a 700 W power limit, for the roofline
# analysis (a card set below 700 W runs slower under load)
CARD = "NVIDIA H100 80GB HBM3"
CARD_POWER_LIMIT_W = 700.0
PEAK_FLOPS_BF16 = 989e12        # dense bf16 on the tensor cores, per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
NVLINK_BW = 450e9               # NVLink 4 bytes/s per direction, per card
CARD_HBM_BYTES = 80 * 1024 ** 3

# collectives this process has issued, by kind ("all_reduce",
# "all_gather", "broadcast", and "shared_all_reduce" for the shared
# all-reduce kernel): one per call, counted where it is called;
# chip_smoke.py resets and reads it around a step
calls: Counter = Counter()

# the production meshes: one HGX board's 8 cards share an NVLink domain,
# so the tensor-parallel axis (``model``, an all-reduce per layer) stays
# inside one board, and ``data`` spans boards over the network; the TPU
# v5e's (16, 16) would put a 16-way tensor-parallel all-reduce across two
# boards' network links
PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def log(msg: str) -> None:
    print(f"[mesh] {msg}", file=sys.stderr, flush=True)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_group() -> None:
    """A world of one rank on an in-process store, where this process
    has no process group."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh(device_type: str, shape: Sequence[int], names: Sequence[str],
          ranks: Optional[Sequence[int]] = None):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= int(s)
    ranks = list(range(n)) if ranks is None else list(ranks)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_federation_mesh(n_ranks: Optional[int] = None,
                         device_type: str = "cuda"):
    """1-D ``("data",)`` mesh over the first ``n_ranks`` ranks of the
    process group (None: all of them), for client-sharded federation
    rounds (``core.federation``, ``mesh=``). Every rank of the group
    calls it; a rank past ``n_ranks`` holds no coordinate on it
    (``in_mesh`` is False) and takes no part in its rounds."""
    if n_ranks is None or int(n_ranks) == 1:
        _ensure_group()
    have = world_size()
    n = have if n_ranks is None else int(n_ranks)
    if not 1 <= n <= have:
        raise ValueError(f"requested {n} ranks, the process group has "
                         f"{have} (start more with run_ranks(n, ...) or "
                         "torchrun --nproc-per-node n)")
    return _mesh(device_type, (n,), ("data",))


def make_host_mesh(device_type: str = "cpu"):
    """1-rank ``("data", "model")`` mesh for CPU tests and examples (no
    sharding)."""
    _ensure_group()
    return _mesh(device_type, (1, 1), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over a process group of 256 ranks, (data=32,
    model=8), or of 512, (pod=2, data=32, model=8): ``pod`` is an outer
    data-parallel axis. The dry runs build it under a fake process group
    of that size."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    need = 1
    for s in shape:
        need *= s
    if world_size() != need:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs {need} ranks, the process group has "
                         f"{world_size()}")
    return _mesh(device_type, shape, names)


def check_mesh(mesh) -> None:
    """``mesh`` is None or a ``DeviceMesh``; anything else is a caller's
    error."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch.mesh.make_federation_mesh) or None, got "
                        f"{type(mesh).__name__}")


def mesh_key(mesh) -> Optional[Tuple]:
    """What a mesh is for a cache: its device type, its ranks laid out in
    its shape, and its axis names; a mesh rebuilt over the same ranks
    has the same key."""
    if mesh is None:
        return None
    return (mesh.device_type, tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh_dim_names))


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _trivial(mesh) -> bool:
    """No mesh, or a mesh of one rank: every collective is a no-op."""
    return mesh is None or mesh.size() == 1


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum ``x`` in place over the ranks along ``axes`` (the reference's
    ``psum``), one ``all_reduce`` per axis; a no-op without a mesh or on
    a 1-rank mesh. A row-strided ``x`` (rows padded past its width, as
    the federation plan's buffers and K1's outputs are) is reduced with
    its pad columns, in one piece. Inside ``graph_collectives`` for this
    mesh the call takes that epoch's route."""
    if _trivial(mesh):
        return x
    whole = x
    if not x.is_contiguous():
        if x.ndim != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
            raise ValueError(f"all_reduce_sum takes contiguous rows, got "
                             f"strides {x.stride()} at {tuple(x.shape)}")
        whole = x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))
    graph = _graph if _graph is not None and _graph.serves(mesh) else None
    for ax in _axes(axes):
        if graph is not None:
            graph.all_reduce(whole, ax)
            continue
        dist.all_reduce(whole, op=dist.ReduceOp.SUM, group=mesh.get_group(ax))
        calls["all_reduce"] += 1
    return x


# ---------------------------------------------------------------------------
# the collectives of a fused epoch
# ---------------------------------------------------------------------------

def graph_route(backend: str, devices: Sequence[Optional[int]]) -> str:
    """How a client-sharded step's all-reduces run inside a fused epoch,
    from the group's backend and each rank's CUDA device index (None: a
    rank on the CPU): ``"plain"`` on the CPU (the rank-order sum over
    gloo: the card's arithmetic, run eagerly), ``"kernel"`` for gloo
    ranks that share one card (the shared all-reduce kernel),
    ``"nccl"`` with one GPU per rank (NCCL's all-reduce, captured in the
    graph). Gloo ranks on several cards raise: gloo stages each call
    through the host, which a CUDA graph cannot capture."""
    on_cpu = [d is None for d in devices]
    if all(on_cpu):
        return "plain"
    if any(on_cpu):
        raise ValueError("a mesh whose ranks are partly on the CPU and "
                         "partly on GPUs has no fused-epoch route")
    if backend == "nccl":
        return "nccl"
    if backend == "gloo" and len(set(devices)) == 1:
        return "kernel"
    raise ValueError(
        f"a client-sharded step on {backend} ranks spread over "
        f"{len(set(devices))} GPUs runs its all-reduces through the host, "
        "which a CUDA graph cannot capture: pass fused_epoch=False (the "
        "launcher's --per-step) to train it on the card")


class GraphCollectives:
    """The all-reduces of a client-sharded step's fused epoch on ``mesh``
    along ``axes``, on this rank's ``device``: the route of each axis's
    group (``graph_route``; every rank of the mesh builds it: the ranks'
    devices are gathered), and for the kernel and plain routes the
    group's ``SharedAllReduce``. ``release()`` (a collective) frees the
    kernel's buffers; the trainer calls it when it drops its graphs."""

    def __init__(self, mesh, axes, device):
        dev = torch.device(device)
        self.key = mesh_key(mesh)
        self.groups = {ax: mesh.get_group(ax) for ax in _axes(axes)}
        self.routes, self.shared = {}, {}
        for ax, group in self.groups.items():
            where: List[Optional[int]] = [None] * dist.get_world_size(group)
            dist.all_gather_object(
                where, torch.cuda.current_device()
                if dev.type == "cuda" else None, group=group)
            self.routes[ax] = graph_route(str(dist.get_backend(group)),
                                          where)
            if self.routes[ax] != "nccl":
                self.shared[ax] = SharedAllReduce(group, dev)

    def serves(self, mesh) -> bool:
        return mesh_key(mesh) == self.key

    def all_reduce(self, x: torch.Tensor, ax: str) -> None:
        route = self.routes[ax]
        if route == "nccl":
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.groups[ax])
            calls["all_reduce"] += 1
        else:
            self.shared[ax].all_reduce(x)
            calls["shared_all_reduce" if route == "kernel"
                  else "all_gather"] += 1

    def error_words(self) -> Optional[torch.Tensor]:
        """The kernels' error words, one device tensor (None without a
        kernel route)."""
        words = [self.shared[ax].error for ax, r in self.routes.items()
                 if r == "kernel"]
        return torch.cat(words) if words else None

    def release(self) -> None:
        for sar in self.shared.values():
            sar.release()


# the collectives of the fused epoch running now (graph_collectives): a
# module variable, not a context variable, because autograd runs the
# backward's reductions (``_ReduceSum.backward``) on a thread of its own
_graph: Optional[GraphCollectives] = None


@contextlib.contextmanager
def graph_collectives(coll: Optional[GraphCollectives]):
    """Route ``all_reduce_sum`` on ``coll``'s mesh through ``coll`` while
    the body runs (None: the backend's own calls)."""
    global _graph
    prev, _graph = _graph, coll
    try:
        yield coll
    finally:
        _graph = prev


def _sum64(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The float64 ``x`` summed over the ranks along ``axes`` through one
    float32 ``all_reduce_sum`` (every route carries float32): each rank
    writes ``x`` as two float32 words, whose sum holds 48 of its 53 bits,
    into its own slot of a zeroed buffer; the all-reduce fills every
    slot, since adding zeros is exact; and the slots add up in float64
    in rank order, the same on every rank whatever the route."""
    idx, count = shard_index(mesh, axes)
    hi = x.float()
    buf = x.new_zeros((count, 2) + tuple(x.shape), dtype=torch.float32)
    buf[idx, 0] = hi
    buf[idx, 1] = (x - hi.double()).float()
    all_reduce_sum(buf, mesh, axes)
    parts = buf.double().sum(1)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if x.dtype == torch.float64:
        return _sum64(x, mesh, axes)
    return all_reduce_sum(x.contiguous().clone(), mesh, axes)


class _ReduceSum(torch.autograd.Function):
    """The sum over the ranks, out of place; its backward is again the
    sum over the ranks: every rank's loss reads the same sum, so each
    rank's input gets the gradients of all of them."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh, ctx.axes), None, None


def reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``all_reduce_sum`` as a differentiable function (a new tensor, the
    input untouched); ``x`` itself without a mesh or on a 1-rank mesh.
    A float64 ``x`` is summed in rank order (``_sum64``), so every rank
    gets the same sum, and one that rounds to the float32 of a single
    float64 sum of every rank's terms. The sharded step reduces its
    server BatchNorm statistics with it (``models.nn._row_stats``)."""
    if _trivial(mesh):
        return x
    return _ReduceSum.apply(x, mesh, axes)


def _by_dtype(tensors: Sequence[torch.Tensor]) -> dict:
    """(dtype, device) -> [(position, tensor)], in order."""
    out: dict = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append((i, t))
    return out


def _pack(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for _, t in ts])


def _unpack_into(flat: torch.Tensor, ts) -> None:
    off = 0
    for _, t in ts:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh, axes) -> None:
    """Sum every tensor in place over the ranks along ``axes``, in one
    ``all_reduce`` per dtype: the tensors go packed into one flat buffer,
    which is reduced and copied back. A no-op without a mesh or on a
    1-rank mesh."""
    if _trivial(mesh):
        return
    for ts in _by_dtype(tensors).values():
        flat = _pack(ts)
        all_reduce_sum(flat, mesh, axes)
        _unpack_into(flat, ts)


def all_gather_rows(tensors: Sequence[torch.Tensor], mesh, axes
                    ) -> List[torch.Tensor]:
    """Each rank's row block ``[k, ...]`` of every tensor becomes the
    whole ``[n k, ...]``, the blocks in the order ``row_block`` numbers
    them (``policy.shard_index``): one ``all_gather`` per dtype and axis,
    the tensors packed into one flat buffer. The tensors themselves
    without a mesh or axes, or on a 1-rank mesh."""
    if _trivial(mesh) or axes is None:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for ts in _by_dtype(tensors).values():
        flat = _pack(ts)
        n = 1
        for ax in reversed(_axes(axes)):       # minor axis first
            group = mesh.get_group(ax)
            size = dist.get_world_size(group)
            buf = flat.new_empty((size,) + tuple(flat.shape))
            dist.all_gather(list(buf.unbind(0)), flat, group=group)
            calls["all_gather"] += 1
            flat, n = buf, n * size
        flat = flat.reshape(n, -1)
        off = 0
        for i, t in ts:
            m = t.numel()
            out[i] = flat[:, off:off + m].reshape(
                (n * t.shape[0],) + tuple(t.shape[1:]))
            off += m
    return out


Items = List[Tuple[Tuple[str, ...], Any]]


def gather_state(items: Items, mesh, axes,
                 rows: Callable[[Tuple[str, ...]], bool]) -> Items:
    """A rank's state, as (path, leaf) pairs, made whole: every leaf whose
    path ``rows`` picks is a row block and is gathered
    (``all_gather_rows``, one collective per dtype), every other leaf is
    replicated and kept as it is."""
    picked = [i for i, (p, _) in enumerate(items) if rows(p)]
    whole = all_gather_rows([items[i][1] for i in picked], mesh, axes)
    out = list(items)
    for i, x in zip(picked, whole):
        out[i] = (items[i][0], x)
    return out


def keep_rows(items: Items, mesh, axes,
              rows: Callable[[Tuple[str, ...]], bool]) -> Items:
    """Inverse of ``gather_state``: this rank's row block
    (``policy.row_block``) of every leaf ``rows`` picks, as a copy, so
    that the whole leaf can be freed; the other leaves as they are, and
    every leaf without a mesh or axes, or on a 1-rank mesh."""
    out = []
    for p, x in items:
        if rows(p) and axes is not None and not _trivial(mesh):
            lo, hi = row_block(mesh, x.shape[0], axes)
            x = x[lo:hi].clone()
        out.append((p, x))
    return out


def barrier(mesh) -> None:
    """Wait for every rank of the mesh; a no-op without a mesh or on a
    1-rank mesh."""
    if not _trivial(mesh):
        for ax in mesh.mesh_dim_names:
            dist.barrier(group=mesh.get_group(ax))


def broadcast_from_first(tensors: Sequence[torch.Tensor], mesh,
                         axes=None) -> None:
    """Overwrite every tensor in place with its value on the mesh's first
    rank along ``axes`` (default: the data axes, 'pod' then 'data'), one
    ``broadcast`` per tensor and axis."""
    if axes is None:
        axes = data_axes(mesh)
    for ax in _axes(axes):
        group = mesh.get_group(ax)
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
            calls["broadcast"] += 1


def broadcast_flat(tensors: Sequence[torch.Tensor], mesh,
                   axes=None) -> None:
    """``broadcast_from_first`` for many tensors in a few collectives:
    the tensors of each dtype go packed into one flat buffer, which is
    broadcast and copied back in place."""
    for ts in _by_dtype(tensors).values():
        flat = _pack(ts)
        broadcast_from_first([flat], mesh, axes)
        _unpack_into(flat, ts)


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def pick_backend(n_ranks: int, device_type: str) -> Tuple[str, str]:
    """(backend, reason) for ``n_ranks`` ranks on ``device_type``: NCCL
    when each rank has a GPU of its own; gloo on the CPU, and when ranks
    share a GPU (NCCL refuses two ranks on one device)."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    n_gpu = torch.cuda.device_count()
    if n_gpu >= n_ranks:
        return "nccl", f"one GPU per rank ({n_ranks} of {n_gpu})"
    return "gloo", f"{n_ranks} ranks share {n_gpu} GPU(s)"


def rank_device(device_type: str) -> torch.device:
    """The device this rank runs on: the CPU, or GPU ``rank % count``."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def init_rank(rank: int, n_ranks: int, init_method: str, device_type: str,
              backend: Optional[str] = None) -> str:
    """Join the process group as ``rank`` of ``n_ranks``; returns the
    backend."""
    backend = backend or pick_backend(n_ranks, device_type)[0]
    kw = {}
    if device_type != "cpu":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n_ranks, rank=rank, **kw)
    return backend


def _rank_main(rank: int, n_ranks: int, init_method: str, device_type: str,
               backend: str, payload: str, queue) -> None:
    torch.set_num_threads(1)
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        init_rank(rank, n_ranks, init_method, device_type, backend)
        out = fn(*args)
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n_ranks: int, fn: Callable, *args: Any,
              device_type: str = "cuda", timeout: float = 900.0
              ) -> List[Any]:
    """Run ``fn(*args)`` in ``n_ranks`` spawned ranks of one process group
    and return each rank's result, in rank order.

    ``fn`` and ``args`` are pickled once, by reference (a module-level
    function) and by value, into a file the ranks read (written into a
    spawned child's pipe, a large argument would hold each start until
    the child before it had imported torch); each rank joins the group
    through a ``file://`` store in a fresh temporary directory (no port
    to race for), runs with one torch thread, and on ``cuda`` binds GPU
    ``rank % count``. A rank that raises fails the call with its
    traceback; the other ranks are stopped."""
    import multiprocessing as mp
    if device_type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"run_ranks on {device_type!r} but CUDA is not "
                           "available; pass device_type='cpu'")
    backend, reason = pick_backend(n_ranks, device_type)
    log(f"{n_ranks} ranks on {device_type}: {backend} ({reason})")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-")
    queue = ctx.Queue()
    init = "file://" + os.path.join(tmp, "store")
    payload = os.path.join(tmp, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, init, device_type, backend,
                               payload, queue), daemon=True)
             for r in range(n_ranks)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < n_ranks:
            try:
                rank, ok, out = queue.get(timeout=1.0)
            except Empty:                   # check on the ranks
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before "
                                       "reporting") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks did not finish in "
                                       f"{timeout:.0f}s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        queue.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n_ranks)]
