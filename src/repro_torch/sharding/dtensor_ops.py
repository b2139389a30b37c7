"""The model's operations on DTensors, where DTensor's own sharding
rules would move more than the reference's partitioner does, or have no
rule at all.

The model modules call these functions (and decorate their attention
functions with them); on plain tensors each one is the plain operation
or the identity, so nothing changes off a mesh. DTensor inputs come from
a mesh run such as the dry runs (``launch.dryrun``), whose parameters,
batches and caches are DTensors with the placements ``policy`` gives the
reference's specs:

* ``fsdp_gather``: parameters gathered along the data axes where a
  layer uses them, under the innermost ``policy.activation_sharding``;
* ``whole_dim``: a stacking axis (layers, clients) whole before a loop
  over it;
* ``pad``, ``embedding``, ``write_slot``: a pad, a vocabulary-parallel
  lookup and a one-slot cache write on each rank's own shard;
* ``local_heads``: attention on each rank's own batch rows and heads;
* ``split_cache_decode``: decode attention over a cache whose slots are
  split across ranks (partial softmaxes combined).

Every DTensor branch is held against the plain path on real values over
gloo ranks by ``tests/test_torch_dtensor_ops.py``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.policy import active_mesh, data_axes


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local_offset(x):
    """(local shape, global offset) of DTensor ``x``'s shard here."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                 x.placements)


# ---------------------------------------------------------------------------
# parameters and stacks
# ---------------------------------------------------------------------------

def fsdp_gather(tree):
    """Parameters as a layer uses them under the innermost
    ``activation_sharding``: every DTensor leaf's shards along the data
    axes are all-gathered (FSDP's gather before use; autograd
    reduce-scatters the gradient back), its tensor-parallel shards kept.
    XLA's partitioner makes this choice for the reference; DTensor's
    propagation, left to itself, would rather move the activations
    (for a vocab head, a [B*S, V] partial sum per rank). The tree as it
    is outside a context, under mesh None, and for plain tensors."""
    mesh, _ = active_mesh()
    if mesh is None:
        return tree
    from torch.distributed.tensor import Replicate
    data = set(data_axes(mesh))

    def gather(x):
        if not _is_dtensor(x):
            return x
        names = x.device_mesh.mesh_dim_names
        want = tuple(Replicate() if n in data else p
                     for n, p in zip(names, x.placements))
        if want == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, want)

    if isinstance(tree, dict):
        return {k: fsdp_gather(v) for k, v in tree.items()}
    return gather(tree)


def whole_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank: a DTensor sharded along
    it is all-gathered along it (its other placements kept); anything
    else as it is. The port's loops over a stacking axis (layers,
    clients) take slices of it, which DTensor refuses along a sharded
    dim, where the reference's ``scan``/``vmap`` let XLA gather it."""
    from torch.distributed.tensor import Replicate, Shard
    if not _is_dtensor(x):
        return x
    d = dim % x.ndim
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == d else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# element-wise layouts: pad, lookup, cache write
# ---------------------------------------------------------------------------

def pad(x, pads, value: float = 0.0):
    """``F.pad(x, pads, value=value)``. A DTensor split along none of the
    padded dims and holding no partial sums pads its local shard, the
    layout kept (DTensor's own rule for a pad fails on some torch
    versions)."""
    from torch.distributed.tensor import DTensor, Shard
    if not _is_dtensor(x):
        return F.pad(x, pads, value=value)
    dims = {x.ndim - 1 - i // 2 for i, n in enumerate(pads) if n}
    if any(not isinstance(p, Shard) and not p.is_replicate() or
           isinstance(p, Shard) and p.dim % x.ndim in dims
           for p in x.placements):
        return F.pad(x, pads, value=value)
    return DTensor.from_local(F.pad(x.to_local(), pads, value=value),
                              x.device_mesh, x.placements, run_check=False)


def embedding(ids, table):
    """``F.embedding(ids, table)``. A DTensor table split along its rows
    (the vocabulary) over some mesh axes, with the ids whole along them,
    is looked up on each rank's own rows: ids outside them give zero rows
    and the result is a partial sum over those axes (the vocabulary-
    parallel embedding). DTensor's own rule for it marks the rows with a
    mask that fails on meta shards on some torch versions."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not _is_dtensor(table) or Shard(0) not in table.placements:
        return F.embedding(ids, table)
    ids_pl = (ids.placements if _is_dtensor(ids)
              else (Replicate(),) * len(table.placements))
    if any(not (t == Shard(0) and i.is_replicate() or t.is_replicate())
           for t, i in zip(table.placements, ids_pl)):
        return F.embedding(ids, table)
    shape, off = _local_offset(table)
    # a rank's rows' gradient sums over the ranks that see other ids
    grad = [t if t == Shard(0) else Partial() if not i.is_replicate()
            else t for t, i in zip(table.placements, ids_pl)]
    rows = table.to_local(grad_placements=grad)
    local = ids.to_local() if _is_dtensor(ids) else ids
    inside = (local >= off[0]) & (local < off[0] + shape[0])
    out = F.embedding(torch.where(inside, local - off[0], 0), rows)
    out = out * inside[..., None].to(out.dtype)
    return DTensor.from_local(
        out, table.device_mesh, [Partial() if t == Shard(0) else i
                                 for t, i in zip(table.placements, ids_pl)],
        run_check=False)


def write_slot(cache: torch.Tensor, idx: int, new: torch.Tensor) -> None:
    """``cache[:, idx] = new`` in place (cast to the cache's dtype). A
    DTensor cache split along its slots is written by the rank that holds
    slot ``idx`` alone, into its own shard (the reference's
    ``dynamic_update_slice`` on a sharded cache); DTensor itself would
    gather the whole cache to select one slot."""
    from torch.distributed.tensor import Replicate, Shard
    if not _is_dtensor(cache):
        cache[:, idx] = new.to(cache.dtype)
        return
    shape, offset = _local_offset(cache)
    # the new token's layout: the cache's over the other dims, whole
    # along the slots' mesh dims (dim 1 of the cache is gone from it)
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                 else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                 else p for p in cache.placements)
    if _is_dtensor(new):
        # every rank joins the redistribution, whether it writes or not
        new = new.redistribute(new.device_mesh, want).to_local()
    if offset[1] <= idx < offset[1] + shape[1]:
        cache.to_local()[:, idx - offset[1]] = new.to(cache.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _rank_local(q, k, v):
    """The local shards of DTensors ``q``, ``k``, ``v`` sharded alike on
    the batch and head dims (0 and 2) only, each dim evenly; else None."""
    from torch.distributed.tensor import Replicate, Shard
    if not _is_dtensor(q):
        return None
    if not all(_is_dtensor(t) and t.placements == q.placements
               and t.device_mesh == q.device_mesh for t in (k, v)):
        return None
    for n, pl in zip(q.device_mesh.shape, q.placements):
        if isinstance(pl, Replicate):
            continue
        if not isinstance(pl, Shard) or pl.dim not in (0, 2):
            return None
        if any(t.shape[pl.dim] % n for t in (q, k)):
            return None
    return tuple(_DenseGrad.apply(t.to_local()) for t in (q, k, v))


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: DTensor views
    the gradient of a local shard by its global layout, which a
    permuted gradient from the rank-local attention does not have."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_heads(fn):
    """Decorates an attention function ``fn(q, k, v, **kw)``: DTensors
    laid out alike, over batch and heads only (the layout the
    tensor-parallel projections give them), run ``fn`` on each rank's own
    shards, since attention is independent per (batch row, head) and a
    rank's query heads read exactly its key heads when both split evenly.
    Any other input goes to ``fn`` as it is (DTensor's rules)."""
    @functools.wraps(fn)
    def run(q, k, v, **kw):
        local = _rank_local(q, k, v)
        if local is None:
            return fn(q, k, v, **kw)
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(fn(*local, **kw), q.device_mesh,
                                  q.placements, run_check=False)
    return run


def split_cache_decode(fn):
    """Decorates a decode attention ``fn(q, k_cache, v_cache, cache_len)``:
    DTensor caches with an int ``cache_len`` go to
    ``decode_over_shards``, anything else to ``fn``."""
    @functools.wraps(fn)
    def run(q, k_cache, v_cache, cache_len):
        if _is_dtensor(k_cache) and not isinstance(cache_len, torch.Tensor):
            return decode_over_shards(q, k_cache, v_cache, cache_len)
        return fn(q, k_cache, v_cache, cache_len)
    return run


def decode_over_shards(q, k_cache, v_cache, cache_len: int):
    """One-token attention (q ``[B, 1, H, hd]``) over DTensor caches
    ``[B, S, KV, hd]`` whose first ``cache_len`` slots are valid: each
    rank attends every query head of its batch rows over its own slots,
    and the ranks that split the slots combine their partial softmaxes
    (a max, then sums of the rescaled denominators and outputs), as a
    split-cache decode does across blocks. Float32; the result has the
    cache's batch layout, its heads whole."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k_cache.device_mesh
    rows = tuple(Shard(0) if p == Shard(0) else Replicate()
                 for p in k_cache.placements)
    if _is_dtensor(q):
        q = q.redistribute(mesh, rows).to_local()
    _, off = _local_offset(k_cache)
    kl, vl = k_cache.to_local().float(), v_cache.to_local().float()
    B, _, H, hd = q.shape
    S, KV = kl.shape[1], kl.shape[2]
    G = H // KV
    s = torch.einsum("bkgh,bskh->bkgs", q.float().reshape(B, KV, G, hd),
                     kl) / math.sqrt(hd)
    valid = (off[1] + torch.arange(S, device=kl.device)) < cache_len
    # a rank whose slots are all masked adds exp(masked - max) = 0
    s = torch.where(valid[None, None, None, :], s, torch.finfo(s.dtype).min)
    slots = [d for d, p in enumerate(k_cache.placements) if p == Shard(1)]
    top = s.amax(-1, keepdim=True)
    for d in slots:
        top = all_reduce(top, "max", (mesh, d))
    p = torch.exp(s - top)
    den = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgs,bskh->bkgh", p, vl)
    for d in slots:
        den = all_reduce(den, "sum", (mesh, d))
        o = all_reduce(o, "sum", (mesh, d))
    out = (o / den).reshape(B, 1, H, hd).to(q.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)
