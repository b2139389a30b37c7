"""Multi-node dry run: trace every (arch x input-shape) pair on the
production mesh with zero device allocation (port of
``repro.launch.dryrun``).

The reference lowers and compiles each pair with XLA over 256 or 512
forced host devices and reads the compiled module's cost and memory
analyses. The port's counterpart is one traced call of the train step,
the prefill or the decode step, run as rank 0 of a fake process group
(``torch.distributed``'s ``fake`` backend: collectives complete at once
and move nothing) on the production mesh:

* parameters, Adam's moments, the batch and the cache are DTensors with
  the placements ``sharding.policy`` gives the reference's specs, built
  with ``DTensor.from_local`` on meta tensors of each leaf's local shard
  shape, outside the counted region (``distribute_tensor`` would issue a
  scatter per leaf); meta tensors carry a shape and a dtype and no
  storage. A ``FakeTensorMode`` around DTensor's sharding propagation
  turns DTensor's own index arithmetic into fake tensors and fails
  (``aten._local_scalar_dense`` in ``local_shard_size_and_offset``), so
  the local shards are meta tensors and no fake mode is entered;
* ``OpCounter``, a dispatch mode, sees every operation DTensor runs on
  the local shards (and skips DTensor's own operations on global shapes
  and the fake tensors of its sharding propagation), so its counts are
  per rank, i.e. per card:

  - ``cost.flops``: ``torch.utils.flop_counter``'s formulas on the local
    shapes (``FlopCounterMode`` entered around DTensor operations counts
    the global product instead);
  - ``cost.bytes_accessed``: bytes read plus bytes written by each
    operation that is not a view, unfused, so it exceeds XLA's fused
    count of the same step;
  - ``collectives``: result bytes per kind (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``, ``broadcast``)
    and ``total``, summed over the functional collectives DTensor issues
    and the c10d collectives of ``launch.mesh``, as the reference sums
    the collectives' results in the optimized HLO. On a ``cpu`` mesh
    DTensor runs an all-to-all as an all-gather and a chunk (the CPU
    process groups have no all-to-all), so the kinds differ from a
    ``cuda`` mesh's there;
  - ``memory``: ``argument_bytes`` (the inputs' local shards, held
    through the call), ``output_bytes``, and ``peak_bytes``, the most
    bytes of distinct storages alive at once (a storage is freed when
    its last tensor goes); ``temp_bytes`` is the peak less arguments
    and outputs.

The port's LM train step returns new parameters and moments (it is not
in place), so its peak holds both copies while the update runs, where
the reference donates its inputs' buffers (``donate``); the decode step
writes its cache in place, as the donated reference does. The port's
blocks run in a Python loop, not a ``lax.scan``, so every layer is
counted: ``calibrate_scan_costs`` records ``cost_corrected`` equal to
the count and ``scan_correction`` 1.0, so that ``roofline`` reads either
package's records alike. A prefill's repeated layers are counted once
and added again (``_Replay``), and so is every token's step of the
mLSTM's and sLSTM's loops (``_StepReplay``): exact in FLOPs, within
0.1 % in bytes and 3 % in peak bytes of running every step.

Parameters sharded over the data axes (FSDP) are gathered where a layer
uses them (``sharding.dtensor_ops.fsdp_gather``), as XLA's partitioner
chooses for the reference; activations take the reference's layouts at
its ``maybe_shard`` sites.

Nothing happens at import: ``start_fake_group`` starts the fake group
(from ``production_mesh`` and ``host_mesh``). A process has one default
group, so ``main`` traces each pair in a spawned worker of its own
(``run_pairs``, which holds each worker to ``PAIR_TIMEOUT_S``), and a
caller of ``build_lowered`` runs in a process of its own, e.g.
``python -m repro_torch.launch.dryrun --arch granite-3-2b --device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.input_specs import decode_window, input_specs, \
    skip_reason
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import AdamState, adam
from repro_torch.sharding.policy import (ShardingPolicy, activation_sharding,
                                         axis_sizes, data_axes, sanitize,
                                         to_placements, tree_param_specs)


# ---------------------------------------------------------------------------
# the fake process group
# ---------------------------------------------------------------------------

def start_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of
    ``world_size`` ranks. A fake group of another size is torn down and
    started again; a default group of another backend is an error (the
    dry run runs in a process of its own)."""
    if dist.is_initialized():
        backend = str(dist.get_backend()).lower()
        if backend != "fake":
            raise RuntimeError(f"this process already has a {backend!r} "
                               "process group; run the dry run in a "
                               "process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    # importing the module registers the backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def stop_fake_group() -> None:
    if dist.is_initialized() and str(dist.get_backend()).lower() == "fake":
        dist.destroy_process_group()


def production_mesh(multi_pod: bool, device: str = "cuda"):
    """``launch.mesh.make_production_mesh`` over a fake group of its
    size (256 or 512 ranks)."""
    shape, _ = mesh_mod.PRODUCTION_SHAPES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    start_fake_group(n)
    return mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                         device_type=device)


def host_mesh(device: str = "cuda"):
    """The 1-rank ``("data", "model")`` mesh, on a fake group of one."""
    start_fake_group(1)
    return mesh_mod.make_host_mesh(device)


def n_ranks(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

# c10d and functional collectives -> the reference's HLO kinds
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_SHAPE_QUERIES = None


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (list, tuple, dict)):
                out.extend(_tensors(x))
        return out
    if isinstance(tree, dict):
        return _tensors(list(tree.values()))
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of the distinct storages behind a tree's tensors (a DTensor
    counts its local shard)."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                        _padding, _dilation, transposed, _output_padding,
                        _groups, output_mask, out_shape=None, **kw) -> int:
    """A convolution's backward: the input's and the weight's gradients
    each make the forward pass's products (``conv_flop_count``)."""
    from torch.utils.flop_counter import conv_flop_count
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def flop_formulas() -> Dict[Any, Callable]:
    """The FLOP formulas the dry run counts with: ``torch.utils.
    flop_counter``'s, the convolution's backward corrected
    (``_conv_backward_flop``). ``FlopCounterMode(custom_mapping=
    FLOP_OVERRIDES())`` counts a real step the same way."""
    from torch.utils.flop_counter import flop_registry, shape_wrapper
    return {**flop_registry, **{k: shape_wrapper(f)
                                for k, f in FLOP_OVERRIDES().items()}}


def FLOP_OVERRIDES() -> Dict[Any, Callable]:
    """``torch.utils.flop_counter``'s formula for a convolution's backward
    counts a grouped convolution's weight gradient ``groups`` times over
    (every input channel times every gradient channel), which the port's
    grouped client convolutions would inflate by the client count; this
    one counts the forward pass's products once per gradient. The
    formulas take shapes (``FlopCounterMode`` wraps them)."""
    return {torch.ops.aten.convolution_backward: _conv_backward_flop}


class OpCounter(TorchDispatchMode):
    """Per-rank FLOPs, bytes, collective bytes and live bytes of the
    operations run on plain (local) tensors while it is entered; see the
    module docstring. ``track(tree)`` counts a tree's storages as live
    from the start (the arguments)."""

    def __init__(self):
        super().__init__()
        self.registry = flop_formulas()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.live: Dict[int, int] = {}
        self.cur = 0
        self.peak = 0

    def track(self, tree) -> None:
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._track(t._local_tensor if isinstance(t, DTensor) else t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            # DTensor runs the local operations with this mode entered
            return NotImplemented
        if (torch._C._meta_in_tls_dispatch_include()
                or any(isinstance(t, FakeTensor) for t in ins)):
            # DTensor's shape propagation on fake global shapes
            return func(*args, **kwargs)
        if func in _shape_queries():
            return func(*args, **kwargs)
        if (not isinstance(func, torch._ops.HigherOrderOperator)
                and func is not torch.ops.prim.device.default):
            # as FlopCounterMode: count a composite through its parts
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out                      # a factory of that propagation
        packet = func._overloadpacket
        name = packet.__name__
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            res = out if "functional" in str(packet) else args[0]
            nb = float(sum(_nbytes(t) for t in _tensors(res)))
            self.collectives[kind] = self.collectives.get(kind, 0.0) + nb
            self.calls[kind] = self.calls.get(kind, 0) + 1
        elif packet in self.registry:
            self.flops += float(self.registry[packet](*args, **kwargs,
                                                     out_val=out))
        if not func.is_view and kind is None and name not in (
                "detach", "alias", "lift_fresh", "wait_tensor",
                "_wrap_tensor_autograd"):
            self.bytes += float(sum(_nbytes(t) for t in ins + outs))
        for t in outs:
            self._track(t)
        return out


def _shape_queries():
    global _SHAPE_QUERIES
    if _SHAPE_QUERIES is None:
        a = torch.ops.aten
        _SHAPE_QUERIES = {
            a.sym_is_contiguous.default, a.is_contiguous.default,
            a.is_contiguous.memory_format, a.is_strides_like_format.default,
            a.is_non_overlapping_and_dense.default, a.size.default,
            a.sym_size.default, a.stride.default, a.sym_stride.default,
            a.storage_offset.default, a.sym_storage_offset.default,
            a.numel.default, a.sym_numel.default, a.dim.default,
            torch.ops.prim.layout.default}
    return _SHAPE_QUERIES


# ---------------------------------------------------------------------------
# sharded stand-ins
# ---------------------------------------------------------------------------

def local_shape(mesh, shape, spec):
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            out[d] //= sizes[ax]
    return tuple(out)


def as_dtensor(mesh, x: torch.Tensor, spec, dtype=None):
    """A DTensor of ``x``'s global shape laid out as ``spec`` (sanitized
    for the mesh), its local shard a meta tensor: no allocation and no
    collective. On a 1-rank mesh the plain meta tensor: the traced call
    then runs the operations a single card runs."""
    from torch.distributed.tensor import DTensor
    if n_ranks(mesh) == 1:
        return torch.empty(tuple(x.shape), dtype=dtype or x.dtype,
                           device="meta")
    spec = sanitize(mesh, x.shape, tuple(spec) + (None,) * (x.ndim - len(spec)))
    local = torch.empty(local_shape(mesh, x.shape, spec),
                        dtype=dtype or x.dtype, device="meta")
    return DTensor.from_local(local, mesh, to_placements(mesh, spec),
                              run_check=False, shape=tuple(x.shape),
                              stride=torch.empty(tuple(x.shape),
                                                 device="meta").stride())


def meta_struct(init: Callable[[], Any]) -> Any:
    """The tree ``init()`` returns, as meta tensors of its leaves' shapes
    and dtypes. ``init`` runs under ``FakeTensorMode`` on the CPU, so
    its random draws and copies allocate nothing (the counterpart of the
    reference's ``jax.eval_shape``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def meta(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(meta(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(meta(v) for v in x)
        if isinstance(x, dict):
            return {k: meta(v) for k, v in x.items()}
        return x
    with FakeTensorMode():
        tree = init()
    return meta(tree)


def _dpa(mesh):
    dp = data_axes(mesh)
    return dp if len(dp) != 1 else dp[0]


def _batch_shardings(mesh, policy, batch_specs):
    """Batch leaves over the data axes (the reference's specs)."""
    dpa = _dpa(mesh)
    return {k: sanitize(mesh, v.shape, (dpa,) + (None,) * (v.ndim - 1))
            for k, v in batch_specs.items()}


def _cache_shardings(mesh, policy, cache_struct):
    """Cache leaves: keys/values batch over data and sequence over model
    (``shard_cache_seq``), recurrent states batch over data."""
    dpa = _dpa(mesh)
    mp = "model" if policy.shard_cache_seq else None

    def spec_for(name, shape):
        if name in ("k", "v", "xk", "xv"):
            s = ((None, dpa, mp, None, None) if len(shape) == 5
                 else (dpa, mp, None, None))
        elif len(shape) >= 2:     # recurrent states [n_super?, B, ...]
            s = ((None, dpa) if len(shape) > 2 else (dpa,)) + \
                (None,) * (len(shape) - (2 if len(shape) > 2 else 1))
        else:
            s = (None,) * len(shape)
        return sanitize(mesh, shape, s)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    None if not isinstance(v, torch.Tensor) else
                    spec_for(k, tuple(v.shape)))
                for k, v in tree.items()}
    return walk(cache_struct)


def _to_dtensors(mesh, tree, specs, dtype=None):
    if isinstance(tree, dict):
        return {k: _to_dtensors(mesh, v, specs[k], dtype)
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return as_dtensor(mesh, tree, specs, dtype)


class _Snapshot:
    """What a region added to an ``OpCounter``: its FLOPs, bytes,
    collective bytes and calls, and the most bytes it held above the
    live bytes it started with."""

    def __init__(self, c: "OpCounter", run: Callable[[], Any]):
        f0, b0 = c.flops, c.bytes
        coll0, calls0 = dict(c.collectives), dict(c.calls)
        base, peak0 = c.cur, c.peak
        c.peak = c.cur
        self.out = run()
        self.flops, self.bytes = c.flops - f0, c.bytes - b0
        self.coll = {k: v - coll0.get(k, 0.0)
                     for k, v in c.collectives.items()}
        self.calls = {k: v - calls0.get(k, 0) for k, v in c.calls.items()}
        self.above = c.peak - base
        c.peak = max(peak0, c.peak)

    def replay(self, c: "OpCounter") -> None:
        c.flops += self.flops
        c.bytes += self.bytes
        for k, v in self.coll.items():
            c.collectives[k] = c.collectives.get(k, 0.0) + v
        for k, v in self.calls.items():
            c.calls[k] = c.calls.get(k, 0) + v
        c.peak = max(c.peak, c.cur + self.above)


def _signature(x):
    """What a replayed call's result depends on: shapes, dtypes and
    layouts of its tensors, and its other arguments."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return ("D", tuple(x.shape), x.dtype, tuple(x.placements),
                id(x.device_mesh))
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return repr(x)


def _spec(x: torch.Tensor):
    return (tuple(x.shape), tuple(x.stride()), x.dtype, x.requires_grad)


def _meta(spec, counter: "OpCounter", requires_grad=False,
          dense=False) -> torch.Tensor:
    """A meta tensor of ``spec``'s shape, dtype and strides (``dense``:
    contiguous, as a gradient is), counted as live."""
    from torch.utils._python_dispatch import _disable_current_modes
    shape, stride, dtype, _ = spec
    with _disable_current_modes():
        t = (torch.empty(shape, dtype=dtype, device="meta") if dense else
             torch.empty_strided(shape, stride, dtype=dtype, device="meta"))
    counter._track(t)
    return t.requires_grad_(requires_grad)


def _fresh(x, counter: "OpCounter"):
    """A new result of ``x``'s structure: meta tensors (DTensors over
    meta shards) of the same shapes, strides, dtypes and layouts, counted
    as live (their making is not counted: the replayed counts hold the
    operations that made the first result)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        new = _meta(_spec(x._local_tensor), counter)
        return DTensor.from_local(new, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    if isinstance(x, torch.Tensor):
        return _meta(_spec(x), counter)
    if isinstance(x, dict):
        return {k: _fresh(v, counter) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_fresh(v, counter) for v in x)
    return x


class _Replay:
    """Within the context, each of the model's sequence functions with
    gradients off (a prefill) runs once per signature (``_signature``);
    a later call with the same signature adds the first call's counts
    and returns fresh meta results of its structure. Every layer of a
    prefill repeats the same calls, and each is hundreds to thousands of
    meta operations: the chunked attention's loop (at 32k tokens, 64
    query chunks by up to 64 key chunks), the RG-LRU's scan, the MoE's
    routing and its eight slots' dispatch, and the mLSTM's and sLSTM's
    projections around their loops (whose steps ``_StepReplay`` replays
    in the first call, and in training). Calls that take gradients run
    every time."""

    TARGETS = (("repro_torch.models.attention", "chunked_attention"),
               ("repro_torch.models.transformer", "chunked_attention"),
               ("repro_torch.models.recurrent", "rglru_seq"),
               ("repro_torch.models.recurrent", "mlstm_seq"),
               ("repro_torch.models.recurrent", "slstm_seq"),
               ("repro_torch.models.transformer", "moe_apply"))

    def __init__(self, counter: "OpCounter"):
        import importlib
        self.counter, self.seen = counter, {}
        self.targets = [(importlib.import_module(m), n)
                        for m, n in self.TARGETS]

    def __enter__(self):
        self.orig = [getattr(m, n) for m, n in self.targets]
        for (m, n), f in zip(self.targets, self.orig):
            setattr(m, n, self._wrap(n, f))
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.targets, self.orig):
            setattr(m, n, f)
        return False

    def _wrap(self, name: str, fn: Callable) -> Callable:
        def call(*args, **kw):
            if torch.is_grad_enabled():
                return fn(*args, **kw)
            key = (name, _signature(args), _signature(kw))
            snap = self.seen.get(key)
            if snap is None:
                snap = self.seen[key] = _Snapshot(
                    self.counter, lambda: fn(*args, **kw))
                return snap.out
            snap.replay(self.counter)
            return _fresh(snap.out, self.counter)
        return call


class _StepRecord:
    """One token's step of a recurrence, run once on stand-ins of its
    inputs: the counts of its forward and (with gradients) its backward,
    its outputs' layouts, and the bytes its backward keeps (the saved
    tensors' storages, less those of the token's inputs, views of the
    whole sequences the loop holds anyway, and of its outputs)."""

    def __init__(self, counter: "OpCounter", fn, cell, state, xt):
        c = counter
        before = (c.flops, c.bytes, dict(c.collectives), dict(c.calls),
                  c.peak)
        grad = torch.is_grad_enabled()
        ins = [_meta(_spec(x), c, grad and x.requires_grad)
               for x in tuple(state) + tuple(xt)]
        st, tok = ins[:len(state)], ins[len(state):]
        whole = {x.untyped_storage()._cdata for x in tok}
        held: Dict[int, int] = {}

        def pack(x):
            key = x.untyped_storage()._cdata
            if key not in whole:
                held[key] = x.untyped_storage().nbytes()
            return x
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            self.fwd = _Snapshot(c, lambda: fn(cell, st, tok))
        outs = self.fwd.out
        self.fwd.out = None
        self.outs = [_spec(o) for o in outs]
        # an output the step saves is counted as the output
        for o in outs:
            held.pop(o.untyped_storage()._cdata, None)
        self.held = sum(held.values())
        self.bwd = None
        if grad:
            diff = [o for o in outs if o.requires_grad]
            need = [x for x in ins if x.requires_grad]
            self.bwd = _Snapshot(c, lambda: torch.autograd.grad(
                diff, need, [_out_grad(o, o is outs[-1], c) for o in diff]))
            self.bwd.out = None
        c.flops, c.bytes, c.collectives, c.calls, c.peak = before


def _out_grad(o: torch.Tensor, stacked: bool, counter: "OpCounter"):
    """A stand-in of the gradient the loop gives a step's output: the
    state's comes from the next step's backward (dense); the last
    output's, which the loop stacks over time, is a slice of the stacked
    gradient (strided along the time axis), as ``unbind`` gives it."""
    if not stacked:
        return _meta(_spec(o), counter, dense=True)
    shape = (o.shape[0], 2) + tuple(o.shape[1:])
    return _meta((shape, None, o.dtype, False), counter, dense=True)[:, 0]


class _ReplayedStep(torch.autograd.Function):
    """A recorded step: its forward's counts and fresh outputs; a stand-in
    of the bytes its backward keeps, saved so that a checkpoint drops and
    recomputes it as it would the step's own; its backward's counts and
    fresh gradients."""

    @staticmethod
    def forward(ctx, counter, rec, *ins):
        rec.fwd.replay(counter)
        held = _meta(((rec.held,), (1,), torch.uint8, False), counter)
        ctx.save_for_backward(held)
        # the last step's state gets no gradient: none is made up for it
        ctx.set_materialize_grads(False)
        ctx.counter, ctx.rec = counter, rec
        ctx.ins = [_spec(x) for x in ins]
        outs = tuple(_meta(o, counter) for o in rec.outs)
        ctx.mark_non_differentiable(*(o for o, spec in zip(outs, rec.outs)
                                      if not spec[3]))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        ctx.rec.bwd.replay(ctx.counter)
        return (None, None) + tuple(
            _meta(spec, ctx.counter, dense=True) if need else None
            for spec, need in zip(ctx.ins, ctx.needs_input_grad[2:]))


class _StepReplay:
    """Within the context, each token's step of the recurrences' loops
    (``recurrent.step``: the mLSTM's and sLSTM's cells on each rank's own
    shards) runs once per signature on stand-ins (``_StepRecord``); every
    step of a loop, the first included, then adds that record's counts
    and returns fresh outputs (``_ReplayedStep`` where gradients are on).
    A loop of S steps thus counts S times one step's forward and
    backward, exactly the products the loop runs (a ``lax.scan`` body
    times its length in the reference's count), without running
    thousands of meta operations per layer. A step given DTensors
    (a layout the rank-local branch refuses) runs as it is."""

    def __init__(self, counter: "OpCounter"):
        self.counter, self.seen = counter, {}

    def __enter__(self):
        from repro_torch.models import recurrent
        self.mod, self.orig = recurrent, recurrent.step
        recurrent.step = self.step
        return self

    def __exit__(self, *exc):
        self.mod.step = self.orig
        return False

    def step(self, cell, state, xt):
        from torch.distributed.tensor import DTensor
        ins = tuple(state) + tuple(xt)
        if any(isinstance(x, DTensor) for x in ins):
            return self.orig(cell, state, xt)
        grad = torch.is_grad_enabled() and any(x.requires_grad for x in ins)
        key = (cell, len(state), grad, tuple(_spec(x) for x in ins))
        rec = self.seen.get(key)
        if rec is None:
            rec = self.seen[key] = _StepRecord(self.counter, self.orig, cell,
                                               state, xt)
        if grad:
            return _ReplayedStep.apply(self.counter, rec, *ins)
        rec.fwd.replay(self.counter)
        return tuple(_meta(o, self.counter) for o in rec.outs)


class Lowered:
    """A traced call waiting to run: ``fn(*args)`` on DTensor inputs
    (``args``), under the mesh's activation layouts."""

    def __init__(self, fn: Callable, args: tuple, mesh, policy):
        self.fn, self.args, self.mesh, self.policy = fn, args, mesh, policy

    def run(self, counter: Optional[OpCounter] = None):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        counter = counter or OpCounter()
        counter.track(self.args)
        with activation_sharding(self.mesh, self.policy), \
                implicit_replication(), _Replay(counter), \
                _StepReplay(counter), counter:
            out = self.fn(*self.args)
        return out, counter


def _input_shape(shape: Union[str, InputShape]) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def build_lowered(arch: str, shape_name: Union[str, InputShape], *,
                  multi_pod: bool, policy: Optional[ShardingPolicy] = None,
                  donate: bool = True, cfg_override=None, mesh=None,
                  device: str = "cuda"):
    """Returns (lowered, meta). ``shape_name`` names an ``INPUT_SHAPES``
    entry or is an ``InputShape``; the record keeps its name. ``mesh``
    None: the production mesh on a fake group of its size. ``donate`` is
    the reference's flag; the
    port's steps are what they are (module docstring), and the record
    says so under ``donated``."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    policy = policy or ShardingPolicy()
    if mesh is None:
        mesh = production_mesh(multi_pod, device)
    shape = _input_shape(shape_name)
    spec = input_specs(cfg, shape)
    params_struct = meta_struct(lambda: T.init_lm(cfg, torch.Generator(),
                                                  device="cpu"))
    param_specs = tree_param_specs(mesh, policy, params_struct)
    params = _to_dtensors(mesh, params_struct, param_specs)
    if spec["kind"] == "train":
        optimizer = adam(1e-4, grad_clip=1.0)
        train_step, _ = T.make_train_step(cfg, optimizer)
        # mu/nu mirror the param shardings, float32 as the optimizer's
        opt = AdamState(0, _to_dtensors(mesh, params_struct, param_specs,
                                        torch.float32),
                        _to_dtensors(mesh, params_struct, param_specs,
                                     torch.float32))
        batch = _to_dtensors(mesh, spec["batch"],
                             _batch_shardings(mesh, policy, spec["batch"]))
        lowered = Lowered(train_step, (params, opt, batch), mesh, policy)
        donated = False
    elif spec["kind"] == "prefill":
        def prefill_fn(params, batch):
            return T.prefill(cfg, params, batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"),
                             enc_frames=batch.get("enc_frames"))
        batch = _to_dtensors(mesh, spec["batch"],
                             _batch_shardings(mesh, policy, spec["batch"]))
        lowered = Lowered(prefill_fn, (params, batch), mesh, policy)
        donated = False
    else:  # decode
        fw = spec["force_window"]

        def serve_step(params, token, cache):
            return T.decode_step(cfg, params, token, cache, force_window=fw)
        token = as_dtensor(mesh, spec["token"],
                           sanitize(mesh, spec["token"].shape, (_dpa(mesh),)))
        cache = _to_dtensors(mesh, spec["cache"],
                             _cache_shardings(mesh, policy, spec["cache"]))
        lowered = Lowered(serve_step, (params, token, cache), mesh, policy)
        donated = True      # the cache is written in place
    meta = {"arch": arch, "shape": shape.name,
            "multi_pod": multi_pod, "kind": spec["kind"],
            "chips": n_ranks(mesh), "params": cfg.param_count(),
            "donated": donated and donate}
    return lowered, meta


def analyze(lowered: Lowered, meta: Dict[str, Any]) -> Dict[str, Any]:
    """Run the traced call once under ``OpCounter``; the record."""
    args_bytes = local_bytes(lowered.args)
    t0 = time.time()
    out, c = lowered.run()
    compile_s = time.time() - t0
    out_bytes = local_bytes(out)
    held = local_bytes((lowered.args, out))     # outputs may alias inputs
    coll = dict(c.collectives)
    coll["total"] = sum(coll.values())
    return dict(meta, compile_s=round(compile_s, 1),
                memory={"argument_bytes": int(args_bytes),
                        "output_bytes": int(out_bytes),
                        "temp_bytes": int(max(0, c.peak - held)),
                        "peak_bytes": int(c.peak)},
                cost={"flops": c.flops, "bytes_accessed": c.bytes},
                collectives=coll, collective_calls=dict(c.calls))


def _cost_tuple(res: Dict[str, Any]) -> Dict[str, float]:
    return {"flops": res["cost"].get("flops", 0.0),
            "bytes": res["cost"].get("bytes_accessed", 0.0),
            "coll": res["collectives"].get("total", 0.0)}


def calibrate_scan_costs(arch: str, shape_name: str, multi_pod: bool,
                         policy: Optional[ShardingPolicy],
                         res: Dict[str, Any]) -> None:
    """The reference corrects XLA's cost analysis, which counts a
    ``lax.scan`` body once, with a depth-2 twin. The port's trace runs
    every layer, so its count is already whole: ``cost_corrected`` is
    the count and ``scan_correction`` 1.0."""
    res["cost_corrected"] = _cost_tuple(res)
    res["scan_correction"] = 1.0


def run_pair(arch: str, shape_name: Union[str, InputShape], multi_pod: bool,
             policy: Optional[ShardingPolicy] = None,
             calibrate: bool = True, device: str = "cuda",
             mesh=None, cfg_override=None) -> Dict[str, Any]:
    """One pair's record (``shape_name`` as in ``build_lowered``)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = _input_shape(shape_name)
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape.name, "multi_pod": multi_pod,
                "skipped": reason}
    lowered, meta = build_lowered(arch, shape, multi_pod=multi_pod,
                                  policy=policy, device=device, mesh=mesh,
                                  cfg_override=cfg_override)
    res = analyze(lowered, meta)
    if calibrate:
        calibrate_scan_costs(arch, shape.name, multi_pod, policy, res)
    if shape.name == "long_500k" and decode_window(cfg, shape):
        res["variant"] = "swa"
    return res


# a pair whose worker runs longer is an ``error`` record
PAIR_TIMEOUT_S = 600


def _pair(arch: str, shape: str, mp: bool, policy: ShardingPolicy,
          device: str) -> Dict[str, Any]:
    """One pair's record, timed, in a worker process (one torch thread,
    the worker's own fake group of the mesh's size): an ``error`` record
    if it raises."""
    torch.set_num_threads(1)
    t0 = time.time()
    try:
        production_mesh(mp, device)
        res = run_pair(arch, shape, mp, policy, device=device)
    except Exception as e:
        res = {"arch": arch, "shape": shape, "multi_pod": mp,
               "error": f"{type(e).__name__}: {e}"}
    res["wall_s"] = round(time.time() - t0, 1)
    return res


def _work(fn: Callable, args: tuple, conn) -> None:
    conn.send(fn(*args))
    conn.close()


def run_pairs(pairs, policy: ShardingPolicy, device: str, jobs: int,
              report: Callable = lambda r: r,
              timeout: float = PAIR_TIMEOUT_S, fn: Callable = _pair):
    """``fn(arch, shape, multi_pod, policy, device)`` for each (arch,
    shape, multi_pod) of ``pairs``, each in a spawned worker of its own
    (a process has one default group, and this one starts none), at most
    ``jobs`` at once; ``report`` takes each record as it comes. The
    parent holds each worker to its deadline, ``timeout`` seconds after
    it started: a worker still running then is terminated (killed if it
    does not end), its slot goes to the next pair, and its pair is an
    ``error`` record with its wall time. A worker that dies without a
    record gives an ``error`` record too. The records, in the order they
    came."""
    import multiprocessing as mproc
    from multiprocessing.connection import wait
    ctx = mproc.get_context("spawn")
    queue, running, out = list(pairs), {}, []

    def failed(pair, why, t0):
        arch, shape, mp = pair
        return {"arch": arch, "shape": shape, "multi_pod": mp, "error": why,
                "wall_s": round(time.time() - t0, 1)}
    try:
        while queue or running:
            while queue and len(running) < jobs:
                pair = queue.pop(0)
                recv, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(target=_work, daemon=True,
                                   args=(fn, tuple(pair) + (policy, device),
                                         send))
                proc.start()
                send.close()
                running[recv] = (proc, pair, time.time())
            left = min(t0 + timeout for _, _, t0 in running.values())
            for recv in wait(list(running), max(0.0, left - time.time())):
                proc, pair, t0 = running.pop(recv)
                try:
                    res = recv.recv()
                except EOFError:
                    proc.join()
                    res = failed(pair, f"worker exited with code "
                                       f"{proc.exitcode}", t0)
                proc.join()
                recv.close()
                out.append(report(res))
            now = time.time()
            for recv, (proc, pair, t0) in list(running.items()):
                if now - t0 < timeout:
                    continue
                proc.terminate()
                proc.join(5)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
                del running[recv]
                recv.close()
                out.append(report(failed(
                    pair, f"traced past {timeout:g} s", t0)))
    finally:
        for proc, _, _ in running.values():
            proc.kill()
            proc.join()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", default=None)
    ap.add_argument("--shape", nargs="+", default=None,
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--no-cache-shard", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu)")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    policy = ShardingPolicy(fsdp=not args.no_fsdp,
                            seq_parallel=not args.no_seq_parallel,
                            shard_cache_seq=not args.no_cache_shard)
    archs = list_archs() if args.all or not args.arch else args.arch
    shapes = list(INPUT_SHAPES) if args.all or not args.shape else args.shape
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    pairs = [(arch, shape, mp) for mp in meshes for arch in archs
             for shape in shapes]

    def report(res):
        tag = (f"{res['arch']} x {res['shape']} x "
               f"{'2pod' if res['multi_pod'] else '1pod'}")
        print(f"[dryrun] {tag}: {status(res)} ({res['wall_s']}s)",
              flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
        return res

    results = run_pairs(pairs, policy, args.device,
                        min(len(pairs), len(os.sched_getaffinity(0))),
                        report)
    if any("error" in r for r in results):
        sys.exit(1)
    return results


def status(res: Dict[str, Any]) -> str:
    if "skipped" in res:
        return "SKIP " + res["skipped"]
    if "error" in res:
        return "ERROR " + res["error"][:200]
    return (f"ok flops={res['cost'].get('flops', 0):.3e} "
            f"coll={res['collectives'].get('total', 0):.3e}B "
            f"peak={res['memory'].get('peak_bytes', 0) / 2**30:.2f}GiB")


if __name__ == "__main__":
    main()
