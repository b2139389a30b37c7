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
  split across ranks (partial softmaxes combined);
* ``local_experts``: the MoE's expert FFN on each rank's own batch rows
  and its own experts (or its slice of ``d_ff``), the partial outputs
  summed over the model axis by one collective;
* ``local_recurrence``: a per-token recurrence (mLSTM, sLSTM) on each
  rank's own batch rows and heads or hidden units, ``heads_out``, the
  mLSTM's head-wise output projection on each rank's shards, and
  ``rows_in``, the sLSTM's output-gate projection, whose weight is split
  along its rows, on each rank's shards;
* ``local_rows``: a row-by-row function (the MoE's top-k) on each rank's
  own rows; ``grad_as_resid``, ``keep_grad_layout`` and ``whole``: the
  MoE's gradients and aux statistics in named layouts;
* ``local_step``: one decode step of such a recurrence on each rank's
  own rows and heads or hidden units, and ``write_state``, its new state
  written into the cache entry in the entry's own layout;
* ``to_param_layout``: the train step's gradients laid out as their
  parameters before the optimizer update, and ``sum_squares``, the
  global norm's sum over them on each rank's shards.

Every DTensor branch is held against the plain path on real values over
gloo ranks by ``tests/test_torch_dtensor_ops.py``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.policy import act_spec, active_mesh, data_axes, \
    maybe_shard, sanitize, to_placements


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


# ---------------------------------------------------------------------------
# experts and recurrences
# ---------------------------------------------------------------------------

def _even(x, placements, mesh) -> bool:
    """Each sharded dim of ``x`` splits evenly over its mesh dims."""
    from torch.distributed.tensor import Shard
    ways = {}
    for n, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            ways[pl.dim] = ways.get(pl.dim, 1) * n
    return all(x.shape[d] % n == 0 for d, n in ways.items())


class _GradTo(torch.autograd.Function):
    """The identity on a DTensor, whose gradient is redistributed to
    ``placements`` (one named collective, where DTensor's own rules for
    the backward ops upstream would otherwise meet it as it came)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad, None


def keep_grad_layout(x):
    """``x`` as it is, its gradient brought to ``x``'s own layout in one
    redistribution (partial sums summed, a whole gradient sliced), so
    the backward ops before ``x`` meet their gradients in their forward
    layout whatever layouts the uses of ``x`` leave them in. The MoE's
    gates (whose gradient the experts leave partial over the model
    axis) and its router's logits and probabilities (whose aux losses'
    gradients come whole over the batch) take it: DTensor's rules for
    the softmax's and the top-k's backward on such gradients differ by
    torch version. Plain tensors as they are."""
    if not _is_dtensor(x):
        return x
    return _GradTo.apply(x, tuple(x.placements))


def local_rows(fn):
    """Decorates ``fn(x, *args) -> tuple`` computed row by row: each
    output's rows (dim 0) are ``x``'s, each from its own row alone. A
    DTensor ``x`` split evenly along its rows or whole, and split along
    nothing else, runs ``fn`` on each rank's own rows; the outputs take
    ``x``'s placements and their gradients come back in them. The MoE's
    top-k takes it: DTensor's rule for the sort's backward (a scatter)
    on batch-split rows differs by torch version (one all-gathers the
    whole batch's scores and indices). Anything else goes to ``fn`` as
    it is."""
    @functools.wraps(fn)
    def run(x, *args, **kw):
        from torch.distributed.tensor import DTensor, Shard
        if not (_is_dtensor(x)
                and all(p == Shard(0) or p.is_replicate()
                        for p in x.placements)
                and _even(x, x.placements, x.device_mesh)):
            return fn(x, *args, **kw)
        out = fn(_DenseGrad.apply(x.to_local()), *args, **kw)
        return tuple(DTensor.from_local(o, x.device_mesh, x.placements,
                                        run_check=False) for o in out)
    return run


def whole(x):
    """``x`` with its partial sums summed (an all-reduce over the mesh
    dims that hold them), its splits kept; anything else as it is. The
    MoE's aux statistics take it, so the losses built from them hold
    no partial sums for DTensor's rules to reduce where they meet."""
    from torch.distributed.tensor import Replicate
    if not _is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def grad_as_resid(x):
    """``x`` ``[B, S, D]`` as it is, its gradient laid out as the
    ``resid`` site lays the residual stream out (a reduce-scatter of
    partial sums onto the sequence-parallel split, a local slice of a
    whole gradient). The MoE's router and its experts read the same
    tokens, and their gradients (one whole, one partial over the model
    axis) then add up in one layout, where DTensor's rules for adding
    the two differ by torch version. Plain tensors, and DTensors
    outside an ``activation_sharding``, as they are."""
    mesh, policy = active_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    spec = sanitize(mesh, x.shape, act_spec(mesh, policy, "resid"))
    return _GradTo.apply(x, tuple(to_placements(x.device_mesh, spec)))


def _expert_shards(x, gate_vals, gate_idx, wi, wg, wo):
    """(local arguments, first local expert, placements of the partial
    output) of the expert FFN's DTensor arguments, or None unless: the
    tokens and gates are laid out alike, each mesh dim splitting their
    batch rows or holding them whole; the weights are split on the same
    mesh dims, by experts (``wi``/``wg``/``wo`` dim 0: expert parallel)
    or by ``d_ff`` (``wi``/``wg`` dim 2 and ``wo`` dim 1: tensor
    parallel), and whole elsewhere; the tokens are whole on the mesh
    dims that split the weights; every split is even."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ws = [w for w in (wi, wg, wo) if w is not None]
    if not all(_is_dtensor(t) for t in [x, gate_vals, gate_idx] + ws):
        return None
    mesh = x.device_mesh
    if any(t.device_mesh != mesh for t in [gate_vals, gate_idx] + ws):
        return None
    if not (gate_vals.placements == gate_idx.placements == x.placements):
        return None
    if any(p not in (Replicate(), Shard(0)) for p in x.placements):
        return None
    # the split of each weight, by kind: dims (wi, wg, wo)
    kinds = {"experts": (0, 0, 0), "ffn": (2, 2, 1)}
    kind = None
    for i, px in enumerate(x.placements):
        pls = (wi.placements[i], (wi if wg is None else wg).placements[i],
               wo.placements[i])
        if all(p == Replicate() for p in pls):
            continue
        split = next((k for k, d in kinds.items()
                      if pls == tuple(Shard(j) for j in d)), None)
        if split is None or kind not in (None, split) or px != Replicate():
            return None
        kind = split
    if not all(_even(t, t.placements, mesh) for t in [x] + ws):
        return None
    split_dims = [i for i, p in enumerate(wi.placements)
                  if p != Replicate()]
    x_grad = [Partial() if i in split_dims else p
              for i, p in enumerate(x.placements)]

    def weight(w):
        if w is None:
            return None
        # a weight's gradient sums over the ranks that split the rows
        grad = [p if i in split_dims else
                Partial() if x.placements[i] == Shard(0) else p
                for i, p in enumerate(w.placements)]
        return _DenseGrad.apply(w.to_local(grad_placements=grad))

    # the gradients leave as partial sums over the ranks that split the
    # weights; summed at once into the tokens' residual layout and the
    # gates' own, so the router's backward runs in its forward layout
    tokens, gates = grad_as_resid(x), keep_grad_layout(gate_vals)
    args = (_DenseGrad.apply(tokens.to_local(grad_placements=x_grad)),
            _DenseGrad.apply(gates.to_local(grad_placements=x_grad)),
            gate_idx.to_local(), weight(wi), weight(wg), weight(wo))
    expert0 = _local_offset(wi)[1][0] if kind == "experts" else 0
    return args, expert0, x_grad


def local_experts(fn):
    """Decorates the MoE's expert FFN ``fn(x, gate_vals, gate_idx, wi,
    wg, wo, *, expert0=0, **kw)`` (float32 ``[B, S, D]``, the sum over
    the experts it is given, numbered from ``expert0``). DTensors laid
    out as ``_expert_shards`` asks (the policy's expert-parallel or
    tensor-parallel weights, tokens split by batch row) run ``fn`` on
    each rank's own rows and experts or ``d_ff`` slice; each rank's
    output is a partial sum over the model axis, summed by one
    collective into the layout of the next ``resid`` site (a
    reduce-scatter onto the sequence-parallel residual; an all-reduce
    where the sequence does not split), in float32 before the caller
    rounds it. No all-to-all: the tokens are whole on every rank of the
    model axis already, and a rank reads its own experts' tokens from
    them. Any other input goes to ``fn`` as it is (DTensor's rules)."""
    @functools.wraps(fn)
    def run(x, gate_vals, gate_idx, wi, wg, wo, **kw):
        local = _expert_shards(x, gate_vals, gate_idx, wi, wg, wo)
        if local is None:
            return fn(x, gate_vals, gate_idx, wi, wg, wo, **kw)
        from torch.distributed.tensor import DTensor
        args, expert0, placements = local
        return _sum_partials(DTensor.from_local(
            fn(*args, expert0=expert0, **kw), x.device_mesh, placements,
            run_check=False))
    return run


def _sum_partials(out):
    """A ``[B, S, D]`` DTensor of partial sums summed into the layout of
    the next ``resid`` site (a reduce-scatter onto the sequence-parallel
    residual), or made whole where no site is active."""
    return whole(maybe_shard(out, "resid"))


def _heads_plan(h, w):
    """(h's, w's and the output's placements) for ``heads_out`` on
    DTensors, per mesh dim: rows split stay split (the weight whole
    there, its gradient summed over them); heads split take the weight
    split by heads; where ``h`` is whole it takes the weight's split of
    the heads or of ``hd``. None for plain tensors, any other layout or
    an uneven split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not (_is_dtensor(h) and _is_dtensor(w)
            and h.device_mesh == w.device_mesh):
        return None
    plan = []
    for ph, pw in zip(h.placements, w.placements):
        if ph == Shard(0) and pw == Replicate():
            plan.append((ph, pw, ph))
        elif ph == Shard(2) and pw in (Replicate(), Shard(0), Shard(1)):
            plan.append((ph, Shard(0), Partial()))
        elif ph == Replicate() and pw in (Shard(0), Shard(1)):
            plan.append((Shard(2 if pw == Shard(0) else 3), pw, Partial()))
        elif ph == Replicate() and pw == Replicate():
            plan.append((ph, pw, ph))
        else:
            return None
    th, tw, out_pl = zip(*plan)
    if not (_even(h, th, h.device_mesh) and _even(w, tw, h.device_mesh)):
        return None
    return th, tw, out_pl


def heads_out(h, w):
    """``einsum("bsnh,nhd->bsd", h, w)``, a head-wise output projection
    (the mLSTM's). DTensors laid out as ``_heads_plan`` allows contract
    on each rank's own shards (``w`` redistributed where the heads
    split, ``h`` sliced locally where it is whole), and the partial sums
    are summed by one collective into the next ``resid`` layout
    (``_sum_partials``): DTensor's own einsum flattens ``(n, h)`` into
    one dim, which some torch versions refuse when the inner of the two
    is split. Anything else goes to the einsum as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    plan = _heads_plan(h, w)
    if plan is None:
        return torch.einsum("bsnh,nhd->bsd", h, w)
    th, tw, out_pl = plan
    mesh = h.device_mesh
    h = h if tuple(h.placements) == th else h.redistribute(mesh, th)
    w = w if tuple(w.placements) == tw else w.redistribute(mesh, tw)
    # the weight's gradient sums over the ranks that split the rows
    w_grad = [Partial() if p == Shard(0) and q == Replicate() else q
              for p, q in zip(th, tw)]
    out = torch.einsum("bsnh,nhd->bsd",
                       _DenseGrad.apply(h.to_local()),
                       _DenseGrad.apply(w.to_local(grad_placements=w_grad)))
    return _sum_partials(DTensor.from_local(out, mesh, out_pl,
                                            run_check=False))


def _rows_plan(x, w):
    """(x's, w's and the output's placements) for ``x @ w`` on DTensors
    ``x [B, S, D]`` and ``w [D, H]``, per mesh dim: rows of ``x`` split
    with ``w`` whole stay split (the weight's gradient summed over them);
    ``w`` split along its rows (``D``) with ``x`` whole takes ``x``'s
    matching slice of ``D``, the products partial sums; both whole stay
    whole. None for plain tensors, any other layout or an uneven
    split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not (_is_dtensor(x) and _is_dtensor(w) and x.ndim == 3
            and w.ndim == 2 and x.device_mesh == w.device_mesh):
        return None
    plan = []
    for px, pw in zip(x.placements, w.placements):
        if px == Shard(0) and pw == Replicate():
            plan.append((px, pw, px))
        elif px == Replicate() and pw == Shard(0):
            plan.append((Shard(2), pw, Partial()))
        elif px == Replicate() and pw == Replicate():
            plan.append((px, pw, px))
        else:
            return None
    tx, tw, out_pl = zip(*plan)
    if not (_even(x, tx, x.device_mesh) and _even(w, tw, x.device_mesh)):
        return None
    return tx, tw, out_pl


def rows_in(x, w, like):
    """``x @ w`` (``x [B, S, D]``, ``w [D, H]``) whose weight the policy
    splits along its rows ``D``, as it splits every ``w_o``: the sLSTM's
    output gate, whose sigmoid needs whole sums. DTensors laid out as
    ``_rows_plan`` allows contract on each rank's own shards, and the
    partial sums are reduce-scattered onto ``like``'s split of ``H``
    (the other gates': their weights split ``H``), one collective;
    where ``like`` holds ``H`` whole, summed whole. Backward, the
    gradient is gathered whole along ``H``, and ``x``'s gradient is a
    partial sum over the ranks that split ``D``, as the other gates'
    contributions to it are, so adding them needs no collective.
    DTensor's own rules for the elementwise op after a product of
    partial sums differ by torch version (one all-reduces to a whole
    ``[B, S, H]`` on every rank and contracts the weight's gradient
    whole; another reduce-scatters along the sequence), so the port
    names the layout. Anything else is the plain product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    plan = _rows_plan(x, w) if _is_dtensor(like) else None
    if plan is None:
        return x @ w
    tx, _, out_pl = plan            # w is laid out as planned
    mesh = x.device_mesh
    target = []
    for p, q in zip(out_pl, like.placements):
        if not p.is_partial():
            target.append(p)
        elif isinstance(q, Shard) and q.dim == 2:
            target.append(q)
        else:
            target.append(Replicate())
    if not _even(like, target, mesh):
        return x @ w
    # x's slice of D taken from its local tensor, whose gradient (zero
    # off the slice) is then a partial sum over the ranks that split D,
    # as the other gates' are: their sum needs no collective
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    x_grad = [Partial() if p == Shard(2) else q
              for p, q in zip(tx, x.placements)]
    (_, _, n), (_, _, off) = compute_local_shape_and_global_offset(
        x.shape, mesh, tx)
    xl = x.to_local(grad_placements=x_grad)[..., off:off + n]
    w_grad = [Partial() if p == Shard(0) and q == Replicate() else q
              for p, q in zip(tx, w.placements)]
    out = torch.matmul(_DenseGrad.apply(xl),
                       _DenseGrad.apply(w.to_local(grad_placements=w_grad)))
    out = DTensor.from_local(out, mesh, out_pl, run_check=False)
    return out.redistribute(mesh, target)


def _rows_heads_target(placements):
    """The recurrences' layout, per mesh dim, of tensors with their
    batch rows on dim 0 and their heads (or hidden units) on dim 2, from
    each one's ``placements``: a mesh dim that splits the heads of any
    splits them in all, one that splits the rows of all keeps them
    split, any other holds them whole."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(2) if Shard(2) in pls else
                 Shard(0) if all(p == Shard(0) for p in pls) else
                 Replicate()
                 for pls in zip(*placements))


def _recurrence_shards(xs):
    """(local shards, placements) of the DTensors ``xs`` ``[B, S, N,
    ...]`` brought to one layout: a mesh dim that splits dim 2 of any
    input splits it in all, one that splits the batch rows (dim 0) of
    all keeps them split, any other holds them whole. An input laid out
    otherwise is redistributed to it (a local slice where it was whole;
    DTensor moves a split of another dim, as a gate whose weight is
    replicated may come split along the sequence). None if an input
    holds partial sums or a split is uneven."""
    from torch.distributed.tensor import Replicate, Shard
    if not all(_is_dtensor(t) and t.device_mesh == xs[0].device_mesh
               and not any(p.is_partial() for p in t.placements)
               for t in xs):
        return None
    mesh = xs[0].device_mesh
    target = _rows_heads_target([t.placements for t in xs])
    if not all(_even(t, target, mesh) for t in xs):
        return None
    out = []
    for t in xs:
        if tuple(t.placements) != target:
            t = t.redistribute(mesh, target)
        out.append(_DenseGrad.apply(t.to_local()))
    return out, target


def local_recurrence(out_dims):
    """Decorates a recurrence ``fn(*xs) -> tuple`` over time, whose
    inputs ``[B, S, N, ...]`` are independent per batch row (dim 0) and
    per index along dim 2 (a head, a hidden unit), and whose output j
    has the batch rows on dim 0 and that index on dim ``out_dims[j]``.
    DTensors (brought to one layout by ``_recurrence_shards``) run
    ``fn`` on each rank's own shards, so no DTensor operation runs
    inside its loop;
    where no mesh dim splits dim 2 (heads that do not divide the model
    axis), every rank of the model axis runs the same rows' loop.
    The shards never split ``hd`` or the sequence: that would need a
    collective per step. Inputs ``_recurrence_shards`` refuses, and plain
    tensors, go to ``fn`` as they are (DTensor's rules)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*xs):
            local = _recurrence_shards(xs)
            if local is None:
                return fn(*xs)
            from torch.distributed.tensor import DTensor, Shard
            shards, placements = local
            mesh = xs[0].device_mesh
            return tuple(
                DTensor.from_local(o, mesh, [Shard(d) if p == Shard(2)
                                             else p for p in placements],
                                   run_check=False)
                for o, d in zip(fn(*shards), out_dims))
        return run
    return wrap


def _step_plan(state, xs):
    """(the state's and the inputs' placements) for ``local_step`` on
    DTensors: ``_rows_heads_target``'s layout, the state's dim 1 standing
    for the inputs' dim 2 (so batch 1, whole on the data axes, stays
    whole). Partial sums are summed into it. None for plain tensors, two
    meshes or an uneven split."""
    from torch.distributed.tensor import Replicate, Shard
    ts = tuple(state) + tuple(xs)
    if not all(_is_dtensor(t) and t.device_mesh == ts[0].device_mesh
               for t in ts):
        return None
    mesh = ts[0].device_mesh
    as_input = {Shard(0): Shard(0), Shard(1): Shard(2)}
    t_in = _rows_heads_target(
        [x.placements for x in xs]
        + [[as_input.get(p, Replicate()) for p in t.placements]
           for t in state])
    t_state = tuple(Shard(1) if p == Shard(2) else p for p in t_in)
    if not (all(_even(t, t_state, mesh) for t in state)
            and all(_even(x, t_in, mesh) for x in xs)):
        return None
    return t_state, t_in


def local_step(cell, state, xs):
    """One decode step of a recurrence: ``cell(*state, *xt) -> (*new
    state, h)``, where ``xt`` are the token's slices ``x[:, 0]`` of the
    inputs ``xs`` ``[B, 1, N, ...]`` and the state's tensors hold the
    batch rows on dim 0 and the index N (a head, a hidden unit) on dim 1
    (the mLSTM's ``C [B, N, hd, hd]``, ``n [B, N, hd]``; the sLSTM's
    ``[B, H]``), as the cell's token inputs do. Returns the new state
    and ``h`` as ``[B, 1, N, ...]``. DTensors laid out as ``_step_plan``
    allows (each redistributed to it where it differs, a local slice
    where it was whole) run ``cell`` on each rank's own rows and heads,
    so no DTensor operation runs inside it: the new state has the plan's
    placements, ``h`` the inputs'. The one-step counterpart of
    ``local_recurrence``, whose rule it keeps; DTensor's own rules for
    the cell's products of differently laid out operands differ by torch
    version (one all-reduces the state inside the cell, another at the
    cache write). Plain tensors, and DTensors the plan refuses, run
    ``cell`` as they are."""
    plan = _step_plan(state, xs)
    if plan is None:
        *new, h = cell(*state, *(x[:, 0] for x in xs))
        return (*new, h[:, None])
    from torch.distributed.tensor import DTensor
    t_state, t_in = plan
    mesh = xs[0].device_mesh

    def local(t, target):
        if tuple(t.placements) != target:
            t = t.redistribute(mesh, target)
        return _DenseGrad.apply(t.to_local())
    *new, h = cell(*(local(t, t_state) for t in state),
                   *(local(x, t_in)[:, 0] for x in xs))
    return (*(DTensor.from_local(t, mesh, t_state, run_check=False)
              for t in new),
            DTensor.from_local(h[:, None], mesh, t_in, run_check=False))


def write_state(dst, new) -> None:
    """``dst.copy_(new)`` in place: a recurrent block's new state into
    its cache entry. A DTensor ``new`` is brought to ``dst``'s placements
    in one redistribution (an all-gather where the step split the state
    finer than the cache holds it, nothing where they are alike) and
    copied shard to shard, so the write never depends on DTensor's rule
    for a ``copy_`` between layouts (one torch version all-reduces a
    partial state there, another inside the step)."""
    if not _is_dtensor(dst):
        dst.copy_(new)
        return
    if tuple(new.placements) != tuple(dst.placements):
        new = new.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(new.to_local())


def to_param_layout(grads, params):
    """``grads`` with each DTensor leaf laid out as its parameter in
    ``params`` (trees alike): partial sums reduce-scattered where the
    parameter is split, all-reduced where it is whole, in one
    redistribution per leaf. The train step calls it between the
    gradients and the optimizer update, so Adam's elementwise ops and the
    global norm run on the parameters' shards whatever layout autograd
    left a gradient in: DTensor's own rules for an op between a partial
    sum and a shard differ by torch version (one all-reduces the
    gradient whole, another reduce-scatters it). Plain tensors, and
    gradients already so laid out, are returned as they are."""
    from repro_torch.tree import tree_map

    def one(g, p):
        if not _is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
            return g
        return g.redistribute(p.device_mesh, p.placements)
    return tree_map(one, grads, params)


def sum_squares(xs):
    """``sum(x.float() ** 2)`` over the tensors ``xs``, a 0-dim float32
    tensor (the square of a global norm). DTensors split or whole, none
    holding partial sums, on one mesh: each rank sums the squares of its
    own shards; the sums of the tensors split over the same mesh dims
    are added and all-reduced over those dims (one 4-byte all-reduce per
    mesh dim; tensors whole everywhere need none), and the result is
    whole on every rank. DTensor's own rule for stacking scalars of
    different layouts is then never asked. Anything else is the plain
    sum, stacked."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate
    if not (xs and all(_is_dtensor(x) and x.device_mesh == xs[0].device_mesh
                       and not any(p.is_partial() for p in x.placements)
                       for x in xs)):
        return torch.stack([torch.sum(torch.square(x.float()))
                            for x in xs]).sum()
    mesh = xs[0].device_mesh
    groups = {}
    for x in xs:
        dims = tuple(i for i, p in enumerate(x.placements)
                     if not p.is_replicate())
        groups.setdefault(dims, []).append(
            torch.sum(torch.square(x.to_local().float())))
    total = None
    for dims, sums in sorted(groups.items()):
        s = torch.stack(sums).sum()
        for d in dims:
            s = all_reduce(s, "sum", (mesh, d))
        total = s if total is None else total + s
    return DTensor.from_local(total, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
