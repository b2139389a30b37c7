"""The port's DTensor paths on real values: ``sharding.dtensor_ops`` and
the model run on DTensors laid out as the dry runs lay them out, against
the plain path on the same values.

One module-scoped spawn of 4 gloo ranks on the CPU
(``launch.mesh.run_ranks``) on a (data 2, model 2) mesh. Every rank
draws the same parameters and inputs from a seed, runs the plain path
on whole tensors and the DTensor path on tensors distributed with the
dry run's placements (``tree_param_specs``, ``_batch_shardings``,
``_cache_shardings``, ``dryrun_paper.split_lm_specs``) under
``activation_sharding`` and ``implicit_replication``, as
``launch.dryrun`` runs its traced calls, and returns the largest
difference of the gathered (``full_tensor``) results:

* each op of ``dtensor_ops`` alone, its value and its input's gradient,
  and the placement that shows its own branch ran (a vocabulary-parallel
  lookup's partial sum, rank-local attention's layout kept);
* a tiny granite-3-2b (dense GQA, tied embeddings): the train loss and
  every parameter's gradient, one Adam step, prefill's logits and cache,
  two decode steps over a cache split along its slots (its logits and
  written cache);
* the split LM's loss and gradients with ``dryrun_paper.RankRows``;
* the MoE FFN (experts split over the model axis, and a count of
  experts that does not divide it: ``d_ff`` split instead), the mLSTM
  (heads split, and heads whole on every rank of the model axis) and
  the sLSTM, each alone (value, aux losses and expert counts, the
  input's and every parameter's gradient) and as a tiny LM's train
  loss and gradients; the rank-local branch counted in every layer (and
  the mLSTM's head-wise output projection on the ranks' shards), and
  the DTensor operations dispatched inside the expert einsums and the
  recurrences' steps counted (none);
* the sLSTM's output-gate projection (``dtensor_ops.rows_in``, its
  weight split along its rows) alone: value and gradients, and its
  FLOPs and collectives per rank counted by the dry run's
  ``OpCounter``, forward and backward, which no torch version's
  DTensor rules choose (the product and its gradients on each rank's
  shards: one reduce-scatter forward, one all-gather backward, the
  input's gradient a partial sum).
* the decode steps (``recurrent.mlstm_step``, ``slstm_step``) alone, at
  batch 4 (rows split over the data axis) and batch 1 (whole on it, as
  long_500k's), from a state laid out as the dry run's cache: value, new
  state and every gradient (input, parameters, state); the one-step
  branch (``dtensor_ops.local_step``) taken and no DTensor operation
  inside the cells; one mLSTM step's FLOPs and collectives per rank,
  exactly; the tiny xLSTM's decode from the plain prefill's cache (its
  logits and written cache, the branch in every recurrent layer);
* the tiny xLSTM's and granite's train step with Adam: every gradient
  that reaches the optimizer has its parameter's placements
  (``dtensor_ops.to_param_layout``), and the update's collectives per
  rank are exact (only the global norm's sums, ``dtensor_ops.
  sum_squares``).

Tolerance: 2e-6 of the largest magnitude of the plain result, for
values and gradients in float32 (the ranks sum partial products in
another order; the largest seen is the split LM's gradients, 8.0e-7);
an Adam step: its bound, 2 lr (a first step moves a parameter by about
lr whatever its gradient's size, so a gradient that changes sign in its
last bits moves it by 2 lr).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.launch import mesh as tmesh  # noqa: E402

REL_TOL = 2e-6
LR = 1e-4
ADAM_TOL = 2 * LR
TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
            d_ff=64, vocab=64, param_dtype="float32")
SPLIT_LAYERS = 6
B, S = 4, 8


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _dist(mesh, tree, specs):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.policy import sanitize, to_placements
    if isinstance(tree, dict):
        return {k: _dist(mesh, v, specs[k]) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    spec = sanitize(mesh, tree.shape,
                    tuple(specs) + (None,) * (tree.ndim - len(specs)))
    return distribute_tensor(tree, mesh, to_placements(mesh, spec))


def _whole(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rel(got, want) -> float:
    """Largest |got - want| over the leaves of two trees, over the
    largest |want|; ints and other leaves must be equal."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    err, scale = 0.0, 0.0
    for k, w in want.items():
        g = _whole(got[k])
        if not isinstance(w, torch.Tensor):
            assert g == w, (k, g, w)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, k
        err = max(err, (g.double() - w.double()).abs().max().item())
        scale = max(scale, w.double().abs().max().item())
    return err / max(scale, 1e-30)


def _abs(got, want) -> float:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    return max((_whole(got[k]).double() - w.double()).abs().max().item()
               for k, w in want.items() if isinstance(w, torch.Tensor))


def _clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _ops(mesh, out):
    """Each op of ``dtensor_ops`` alone."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard, \
        distribute_tensor
    from repro_torch.models import attention as A
    from repro_torch.sharding import dtensor_ops as dt
    g = torch.Generator().manual_seed(1)
    rows_heads = [Shard(0), Shard(2)]

    # vocabulary-parallel lookup: value, placement, the table's gradient
    table = torch.randn(64, 16, generator=g)
    ids = torch.randint(0, 64, (B, S), generator=g)
    w = torch.randn(B, S, 16, generator=g)
    t0 = table.clone().requires_grad_(True)
    (F.embedding(ids, t0) * w).sum().backward()
    dtab = distribute_tensor(table, mesh, [Replicate(), Shard(0)])
    dtab.requires_grad_(True)
    dids = distribute_tensor(ids, mesh, [Shard(0), Replicate()])
    y = dt.embedding(dids, dtab)
    out["embedding/partial"] = float(y.placements[1] == Partial())
    (y.full_tensor() * w).sum().backward()
    out["embedding/value"] = _rel(y, F.embedding(ids, table))
    out["embedding/grad"] = _rel(dtab.grad, t0.grad)

    # pad along an unsplit dim, on the local shards
    x = torch.randn(B, S, 8, generator=g)
    dx = distribute_tensor(x, mesh, [Shard(0), Shard(2)])
    y = dt.pad(dx, (0, 0, 3, 0), value=1.0)
    out["pad/layout_kept"] = float(tuple(y.placements) == (Shard(0),
                                                           Shard(2)))
    out["pad/value"] = _rel(y, F.pad(x, (0, 0, 3, 0), value=1.0))

    # a one-slot write into a cache split along its slots, by its owner
    for idx in (2, 13):
        cache = torch.randn(B, 24, 2, 8, generator=g)
        new = torch.randn(B, 2, 8, generator=g)
        dcache = distribute_tensor(cache, mesh, [Shard(0), Shard(1)])
        dnew = distribute_tensor(new, mesh, [Shard(0), Shard(1)])
        dt.write_slot(dcache, idx, dnew)
        cache[:, idx] = new
        out[f"write_slot/{idx}"] = _rel(dcache, cache)

    # decode over a cache split along its slots (12 per rank of the model
    # axis): valid lengths that mask the second rank's whole shard, part
    # of it, and none of it
    q = torch.randn(B, 1, 4, 8, generator=g)
    k = torch.randn(B, 24, 2, 8, generator=g)
    v = torch.randn(B, 24, 2, 8, generator=g)
    for n in (5, 13, 24):
        want = A.decode_attention(q, k, v, n)
        got = A.decode_attention(
            distribute_tensor(q, mesh, rows_heads),
            distribute_tensor(k, mesh, [Shard(0), Shard(1)]),
            distribute_tensor(v, mesh, [Shard(0), Shard(1)]), n)
        out[f"decode_over_shards/{n}"] = _rel(got, want)

    # attention per rank over batch rows and heads, and its gradients
    q = torch.randn(B, S, 4, 8, generator=g)
    k = torch.randn(B, S, 2, 8, generator=g)
    v = torch.randn(B, S, 2, 8, generator=g)
    w = torch.randn(B, S, 4, 8, generator=g)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (A.chunked_attention(*plain, q_chunk=4, k_chunk=4) * w).sum().backward()
    dist_in = [distribute_tensor(t, mesh, rows_heads).requires_grad_(True)
               for t in (q, k, v)]
    y = A.chunked_attention(*dist_in, q_chunk=4, k_chunk=4)
    out["local_heads/layout_kept"] = float(tuple(y.placements)
                                           == tuple(rows_heads))
    (y.full_tensor() * w).sum().backward()
    out["local_heads/value"] = _rel(
        y, A.chunked_attention(q, k, v, q_chunk=4, k_chunk=4))
    out["local_heads/grad"] = _rel([t.grad for t in dist_in],
                                   [t.grad for t in plain])


def _lm(mesh, out):
    """The tiny LM's train step, prefill and decode."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam
    from repro_torch.sharding import dtensor_ops as dt
    from repro_torch.sharding.policy import (ShardingPolicy,
                                             activation_sharding,
                                             tree_param_specs)
    cfg = dataclasses.replace(get_config("granite-3-2b"), **TINY)
    policy = ShardingPolicy()
    g = torch.Generator().manual_seed(0)
    params = T.init_lm(cfg, g, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    dparams = _dist(mesh, params, tree_param_specs(mesh, policy, params))
    dbatch = _dist(mesh, batch, D._batch_shardings(mesh, policy, batch))

    # count the rank-local branches the model takes
    taken = {"local_heads": 0, "decode_over_shards": 0}
    rank_local, over_shards = dt._rank_local, dt.decode_over_shards

    def counted_local(*a):
        r = rank_local(*a)
        taken["local_heads"] += r is not None
        return r

    def counted_decode(*a):
        taken["decode_over_shards"] += 1
        return over_shards(*a)
    dt._rank_local, dt.decode_over_shards = counted_local, counted_decode

    def on_mesh(fn):
        with activation_sharding(mesh, policy), implicit_replication():
            return fn()

    try:
        loss0, _, g0 = T.value_and_grad(
            lambda p: T.lm_loss(cfg, p, batch), params)
        loss1, _, g1 = on_mesh(lambda: T.value_and_grad(
            lambda p: T.lm_loss(cfg, p, dbatch), dparams))
        out["train/loss"] = _rel(loss1, loss0)
        out["train/grads"] = _rel(g1, g0)

        step, opt_init = T.make_train_step(cfg, adam(LR, grad_clip=1.0))
        p0, _, m0 = step(params, opt_init(params), batch)
        p1, _, m1 = on_mesh(lambda: step(dparams, opt_init(dparams),
                                         dbatch))
        out["adam_step/loss"] = _rel(m1["loss"], m0["loss"])
        out["adam_step/params_abs"] = _abs(p1, p0)

        logits0, cache0 = T.prefill(cfg, params, batch["tokens"])
        logits1, cache1 = on_mesh(lambda: T.prefill(cfg, dparams,
                                                    dbatch["tokens"]))
        out["prefill/logits"] = _rel(logits1, logits0)
        out["prefill/cache"] = _rel(cache1, cache0)

        # decode from the plain prefill's cache, laid out as the dry run
        # lays a decode cache out (batch over data, slots over model)
        dcache = _dist(mesh, _clone(cache0),
                       D._cache_shardings(mesh, policy, cache0))
        for i in range(2):
            token = torch.randint(0, cfg.vocab, (B,), generator=g)
            dtoken = distribute_tensor(
                token, mesh, D.to_placements(mesh, D.sanitize(
                    mesh, (B,), (D._dpa(mesh),))))
            logits0, cache0 = T.decode_step(cfg, params, token, cache0)
            logits1, dcache = on_mesh(lambda: T.decode_step(
                cfg, dparams, dtoken, dcache))
            out[f"decode{i}/logits"] = _rel(logits1, logits0)
            out[f"decode{i}/cache"] = _rel(dcache, cache0)
    finally:
        dt._rank_local, dt.decode_over_shards = rank_local, over_shards
    out["taken/local_heads"] = float(taken["local_heads"])
    out["taken/decode_over_shards"] = float(taken["decode_over_shards"])


def _split_lm(mesh, out):
    """The split LM's loss and gradients, each rank on its own clients."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.core import split_transformer as ST
    from repro_torch.launch import dryrun_paper as DP
    from repro_torch.models import transformer as T
    from repro_torch.sharding.policy import (ShardingPolicy,
                                             activation_sharding, sanitize)
    cfg = dataclasses.replace(get_config("granite-3-2b"),
                              **dict(TINY, n_layers=SPLIT_LAYERS))
    policy = ShardingPolicy()
    groups = ST.default_groups(cfg)
    g = torch.Generator().manual_seed(2)
    params = ST.init_split_lm(cfg, groups, g, device="cpu")
    tok = {gr.name: torch.randint(0, cfg.vocab, (gr.n_clients, 2, S),
                                  generator=g) for gr in groups}
    lab = {gr.name: torch.randint(0, cfg.vocab, (gr.n_clients, 2, S),
                                  generator=g) for gr in groups}
    batch = {"tokens": tok, "labels": lab}
    dparams = _dist(mesh, params, DP.split_lm_specs(mesh, policy, params))
    bspec = {gr.name: sanitize(mesh, tok[gr.name].shape,
                               (DP._dpa(mesh), None, None))
             for gr in groups}
    dbatch = {"tokens": _dist(mesh, tok, bspec),
              "labels": _dist(mesh, lab, bspec)}
    rows = DP.RankRows.of(dparams["clients"])
    out["split_lm/rank_rows"] = float(rows is not None)
    loss0, _, g0 = T.value_and_grad(
        lambda p: ST.split_lm_loss(cfg, p, groups, batch), params)
    with activation_sharding(mesh, policy), implicit_replication():
        loss1, _, g1 = T.value_and_grad(
            lambda p: ST.split_lm_loss(cfg, p, groups, dbatch, rows),
            dparams)
    out["split_lm/loss"] = _rel(loss1, loss0)
    out["split_lm/grads"] = _rel(g1, g0)


class _DTensorOps:
    """Counts the DTensor operations dispatched while it is entered
    (a dispatch mode sees them before DTensor does)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(isinstance(t, DTensor)
                       for t in tree_leaves((args, kwargs or {}))):
                    counter.n += 1
                    return NotImplemented
                return func(*args, **(kwargs or {}))
        self.n, self.calls, self.mode = 0, 0, Mode

    def wrap(self, fn):
        def run(*a, **k):
            self.calls += 1
            with self.mode():
                return fn(*a, **k)
        return run


MOE_CASES = {"moe_ep": 4, "moe_tp": 3}        # experts on a 2-way axis
RECURRENT_CASES = {"mlstm_split": 4, "mlstm_whole": 3}   # heads


def _tiny(case):
    from repro_torch.configs import get_config
    if case in MOE_CASES:
        return dataclasses.replace(get_config("granite-moe-1b-a400m"),
                                   **TINY, n_experts=MOE_CASES[case],
                                   moe_top_k=2)
    return dataclasses.replace(get_config("xlstm-350m"),
                               **dict(TINY, n_heads=RECURRENT_CASES[case],
                                      n_kv_heads=RECURRENT_CASES[case],
                                      d_ff=0, d_rnn=16))


def _layer(mesh, out, case, kind, cfg):
    """One MoE, mLSTM or sLSTM layer alone: its value (and the MoE's aux
    losses and counts), the input's and every parameter's gradient."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe as M
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor_ops as dt
    from repro_torch.sharding.policy import (ShardingPolicy, act_spec,
                                             activation_sharding, sanitize,
                                             to_placements, tree_param_specs)
    policy = ShardingPolicy()
    g = torch.Generator().manual_seed(3)
    params = T.init_block(cfg, kind, g, "cpu")
    name = {"attn": "moe"}.get(kind, kind)
    params = {name: params[name]}
    x = torch.randn(B, S, cfg.d_model, generator=g)
    w = torch.randn(B, S, cfg.d_model, generator=g)

    def apply(p, x):
        if kind == "attn":
            o, aux = M.moe_apply(p["moe"], x, top_k=cfg.moe_top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 mlp_variant=cfg.mlp_variant)
            return o, aux, aux["load_balance"] + 1e-3 * aux["router_z"]
        o, st = getattr(R, f"{kind}_seq")(p[kind], x)
        return o, st, torch.zeros(())

    def run(p, x):
        p = T.tree_map(lambda t: t.detach().requires_grad_(True), p)
        x = x.detach().requires_grad_(True)
        o, aux, extra = apply(dt.fsdp_gather(p), x)
        loss = (_whole(o) * w).sum() + _whole(extra)
        flat = [x] + list(T.tree_leaves(p))
        grads = torch.autograd.grad(loss, flat)
        return o, aux, grads

    o0, aux0, g0 = run(params, x)
    dparams = _dist(mesh, params, tree_param_specs(mesh, policy, params))
    spec = sanitize(mesh, x.shape, act_spec(mesh, policy, "resid_inner"))
    dx = distribute_tensor(x, mesh, to_placements(mesh, spec))
    with activation_sharding(mesh, policy), implicit_replication():
        o1, aux1, g1 = run(dparams, dx)
    out[f"{case}/{kind}/value"] = _rel(o1, o0)
    out[f"{case}/{kind}/aux"] = _rel(aux1, aux0)
    out[f"{case}/{kind}/grads"] = _rel(list(g1), list(g0))


def _branches(mesh, out):
    """The MoE and recurrent layers alone and in a tiny LM's train step,
    with their rank-local branches and the DTensor operations inside
    them counted."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun as D
    from repro_torch.models import moe as M
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor_ops as dt
    from repro_torch.sharding.policy import (ShardingPolicy,
                                             activation_sharding,
                                             tree_param_specs)
    policy = ShardingPolicy()
    taken = {"experts": 0, "recurrence": 0, "heads_out": 0, "rows_in": 0}
    expert_shards, recurrence_shards = dt._expert_shards, dt._recurrence_shards
    heads_plan, rows_plan = dt._heads_plan, dt._rows_plan

    def counted(key, fn):
        def run(*a):
            r = fn(*a)
            taken[key] += r is not None
            return r
        return run
    inner = {"experts": _DTensorOps(), "recurrence": _DTensorOps()}
    orig = {(M, "route"): M.route, (M, "expert_ffn"): M.expert_ffn,
            (R, "_mlstm_cell"): R._mlstm_cell,
            (R, "_slstm_cell"): R._slstm_cell}
    dt._expert_shards = counted("experts", expert_shards)
    dt._recurrence_shards = counted("recurrence", recurrence_shards)
    dt._heads_plan = counted("heads_out", heads_plan)
    dt._rows_plan = counted("rows_in", rows_plan)
    for (mod, name), fn in orig.items():
        setattr(mod, name, inner["experts" if mod is M
                                 else "recurrence"].wrap(fn))
    try:
        for case in list(MOE_CASES) + list(RECURRENT_CASES):
            cfg = _tiny(case)
            kinds = ("attn",) if case in MOE_CASES else ("slstm", "mlstm")
            for kind in kinds:
                if case == "mlstm_whole" and kind == "slstm":
                    continue            # the same sLSTM as "mlstm_split"
                before = dict(taken)
                _layer(mesh, out, case, kind, cfg)
                key = "experts" if kind == "attn" else "recurrence"
                out[f"taken/{case}/{kind}"] = float(
                    taken[key] - before[key])
                if kind == "mlstm":
                    out[f"taken/{case}/heads_out"] = float(
                        taken["heads_out"] - before["heads_out"])
                if kind == "slstm":
                    out[f"taken/{case}/rows_in"] = float(
                        taken["rows_in"] - before["rows_in"])
            # the tiny LM: a train loss and every parameter's gradient
            g = torch.Generator().manual_seed(4)
            params = T.init_lm(cfg, g, device="cpu")
            batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                             generator=g),
                     "labels": torch.randint(0, cfg.vocab, (B, S),
                                             generator=g)}
            dparams = _dist(mesh, params,
                            tree_param_specs(mesh, policy, params))
            dbatch = _dist(mesh, batch,
                           D._batch_shardings(mesh, policy, batch))
            loss0, aux0, g0 = T.value_and_grad(
                lambda p: T.lm_loss(cfg, p, batch), params)
            before = dict(taken)
            with activation_sharding(mesh, policy), implicit_replication():
                loss1, aux1, g1 = T.value_and_grad(
                    lambda p: T.lm_loss(cfg, p, dbatch), dparams)
            out[f"{case}/lm/loss"] = _rel([loss1, aux1], [loss0, aux0])
            out[f"{case}/lm/grads"] = _rel(g1, g0)
            # a recomputed super-block takes the branch twice per layer
            key = "experts" if case in MOE_CASES else "recurrence"
            out[f"taken/{case}/lm"] = float(taken[key] - before[key])
            out[f"taken/{case}/lm_rows_in"] = float(taken["rows_in"]
                                                    - before["rows_in"])
    finally:
        dt._expert_shards, dt._recurrence_shards = (expert_shards,
                                                    recurrence_shards)
        dt._heads_plan, dt._rows_plan = heads_plan, rows_plan
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
    for key, c in inner.items():
        out[f"inner/{key}/dtensor_ops"] = float(c.n)
        out[f"inner/{key}/calls"] = float(c.calls)
    # the counter sees a DTensor operation where one runs
    control = _DTensorOps()
    x = distribute_tensor(torch.ones(B, S), mesh, [Shard(0), Replicate()])
    control.wrap(lambda: x + 1)()
    out["inner/control/dtensor_ops"] = float(control.n)


def _rows_in(mesh, out):
    """``dtensor_ops.rows_in`` alone at the tiny xLSTM's widths (d_model
    32, d_rnn 16): value, gradients, and its counts per rank."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import dryrun as D
    from repro_torch.sharding import dtensor_ops as dt
    cfg = _tiny("mlstm_split")
    g = torch.Generator().manual_seed(5)
    x, w, like, go = (torch.randn(shape, generator=g) for shape in (
        (B, S, cfg.d_model), (cfg.d_model, cfg.d_rnn), (B, S, cfg.d_rnn),
        (B, S, cfg.d_rnn)))
    dx = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    dw = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
    dlike = distribute_tensor(like, mesh, [Shard(0), Shard(2)])
    dx.requires_grad_(True)
    dw.requires_grad_(True)
    counts = {}
    with D.OpCounter() as c:
        y = dt.rows_in(dx, dw, dlike)
    counts["forward"] = (c.flops, dict(c.collectives), dict(c.calls))
    with D.OpCounter() as c:
        gx, gw = torch.autograd.grad(
            y, [dx, dw], distribute_tensor(go, mesh, list(y.placements)))
    counts["backward"] = (c.flops, dict(c.collectives), dict(c.calls))
    x.requires_grad_(True)
    w.requires_grad_(True)
    y0 = x @ w
    g0 = torch.autograd.grad(y0, [x, w], go)
    out["rows_in/value"] = _rel(y, y0)
    out["rows_in/grads"] = _rel([gx, gw], list(g0))
    out["rows_in/layout"] = (tuple(y.placements) == tuple(dlike.placements)
                             and gx.placements[1].is_partial())
    out["rows_in/counts"] = counts


STEP_BATCHES = (4, 1)             # rows split over data, and whole


def _decode_steps(mesh, out):
    """The mLSTM's and sLSTM's decode steps alone, and the tiny xLSTM's
    decode, on the mesh against the plain path; the one-step branch and
    the DTensor operations inside the cells counted; one mLSTM step's
    counts per rank."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun as D
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor_ops as dt
    from repro_torch.sharding.policy import (ShardingPolicy, act_spec,
                                             activation_sharding, sanitize,
                                             to_placements, tree_param_specs)
    policy = ShardingPolicy()
    taken = {"step": 0}
    step_plan = dt._step_plan

    def counted(*a):
        r = step_plan(*a)
        taken["step"] += r is not None
        return r
    inner = _DTensorOps()
    cells = {"_mlstm_cell": R._mlstm_cell, "_slstm_cell": R._slstm_cell}
    dt._step_plan = counted
    for name, fn in cells.items():
        setattr(R, name, inner.wrap(fn))

    def dist(x, kind):
        spec = sanitize(mesh, x.shape, act_spec(mesh, policy, kind))
        return distribute_tensor(x, mesh, to_placements(mesh, spec))

    try:
        for case in RECURRENT_CASES:
            cfg = _tiny(case)
            for kind in ("mlstm", "slstm"):
                if case == "mlstm_whole" and kind == "slstm":
                    continue            # the same sLSTM as "mlstm_split"
                g = torch.Generator().manual_seed(6)
                params = {kind: T.init_block(cfg, kind, g, "cpu")[kind]}
                dparams = _dist(mesh, params,
                                tree_param_specs(mesh, policy, params))
                for b in STEP_BATCHES:
                    # a state from a few tokens, laid out as the cache's
                    seq = torch.randn(b, 3, cfg.d_model, generator=g)
                    state = getattr(R, f"{kind}_seq")(params[kind], seq)[1]
                    x = torch.randn(b, 1, cfg.d_model, generator=g)
                    w = torch.randn(b, 1, cfg.d_model, generator=g)
                    ws = {n: torch.randn(t.shape, generator=g)
                          for n, t in state.items()}
                    step = getattr(R, f"{kind}_step")

                    def run(p, x, st):
                        p = T.tree_map(
                            lambda t: t.detach().requires_grad_(True), p)
                        x = x.detach().requires_grad_(True)
                        st = {n: t.detach().requires_grad_(True)
                              for n, t in st.items()}
                        o, new = step(dt.fsdp_gather(p)[kind], x, st)
                        loss = (_whole(o) * w).sum() + sum(
                            (_whole(new[n]) * ws[n]).sum() for n in new)
                        flat = ([x] + list(T.tree_leaves(p))
                                + [st[n] for n in sorted(st)])
                        return o, new, torch.autograd.grad(loss, flat)

                    o0, new0, g0 = run(params, x, state)
                    before = taken["step"]
                    with activation_sharding(mesh, policy), \
                            implicit_replication():
                        o1, new1, g1 = run(
                            dparams, dist(x, "resid_inner"),
                            {n: dist(t, "state") for n, t in state.items()})
                    key = f"{case}/{kind}_step/b{b}"
                    out[f"{key}/value"] = _rel(o1, o0)
                    out[f"{key}/state"] = _rel(new1, new0)
                    out[f"{key}/grads"] = _rel(list(g1), list(g0))
                    out[f"taken/{key}"] = float(taken["step"] - before)
                    if kind == "mlstm" and b == STEP_BATCHES[0]:
                        out[f"{case}/mlstm_step/counts"] = _step_counts(
                            mesh, policy, dparams, dist(x, "resid_inner"),
                            {n: dist(t, "state") for n, t in state.items()})
            # the tiny xLSTM's decode from the plain prefill's cache
            g = torch.Generator().manual_seed(7)
            params = T.init_lm(cfg, g, device="cpu")
            dparams = _dist(mesh, params,
                            tree_param_specs(mesh, policy, params))
            tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
            _, cache0 = T.prefill(cfg, params, tokens)
            dcache = _dist(mesh, _clone(cache0),
                           D._cache_shardings(mesh, policy, cache0))
            before = taken["step"]
            for i in range(2):
                token = torch.randint(0, cfg.vocab, (B,), generator=g)
                dtoken = distribute_tensor(
                    token, mesh, to_placements(mesh, sanitize(
                        mesh, (B,), (D._dpa(mesh),))))
                logits0, cache0 = T.decode_step(cfg, params, token, cache0)
                with activation_sharding(mesh, policy), \
                        implicit_replication():
                    logits1, dcache = T.decode_step(cfg, dparams, dtoken,
                                                    dcache)
                out[f"{case}/decode{i}/logits"] = _rel(logits1, logits0)
                out[f"{case}/decode{i}/cache"] = _rel(dcache, cache0)
            out[f"taken/{case}/decode"] = float(taken["step"] - before)
    finally:
        dt._step_plan = step_plan
        for name, fn in cells.items():
            setattr(R, name, fn)
    out["inner/decode/dtensor_ops"] = float(inner.n)
    out["inner/decode/calls"] = float(inner.calls)


def _step_counts(mesh, policy, dparams, dx, dstate):
    """One mLSTM decode step's FLOPs and collectives on this rank (the
    dry run's ``OpCounter``), as the decode block runs it: no gradients,
    its parameters gathered outside."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun as D
    from repro_torch.models import recurrent as R
    from repro_torch.sharding import dtensor_ops as dt
    from repro_torch.sharding.policy import activation_sharding
    with torch.no_grad(), activation_sharding(mesh, policy), \
            implicit_replication():
        p = dt.fsdp_gather(dparams)["mlstm"]
        with D.OpCounter() as c:
            R.mlstm_step(p, dx, dstate)
    return c.flops, dict(c.collectives), dict(c.calls)


def _optimizer(mesh, out):
    """The tiny xLSTM's and granite's train step with Adam on the mesh:
    the gradients' placements where they reach the update, the update's
    collectives per rank, the loss and the new parameters against the
    plain step."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam
    from repro_torch.sharding.policy import (ShardingPolicy,
                                             activation_sharding,
                                             tree_param_specs)
    policy = ShardingPolicy()
    for name, cfg in (("xlstm", _tiny("mlstm_whole")),
                      ("granite", dataclasses.replace(
                          get_config("granite-3-2b"), **TINY))):
        opt_init, update = adam(LR, grad_clip=1.0)
        seen = {}

        def watched(state, grads, params):
            seen["mismatch"] = [
                k for k, gr in _leaves(grads)
                if tuple(gr.placements) != tuple(dict(_leaves(params))[k]
                                                 .placements)]
            with D.OpCounter() as c:
                r = update(state, grads, params)
            seen["counts"] = (dict(c.collectives), dict(c.calls))
            return r
        g = torch.Generator().manual_seed(8)
        params = T.init_lm(cfg, g, device="cpu")
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g),
                 "labels": torch.randint(0, cfg.vocab, (B, S), generator=g)}
        dparams = _dist(mesh, params, tree_param_specs(mesh, policy, params))
        dbatch = _dist(mesh, batch, D._batch_shardings(mesh, policy, batch))
        step0, _ = T.make_train_step(cfg, (opt_init, update))
        p0, _, m0 = step0(params, opt_init(params), batch)
        step1, _ = T.make_train_step(cfg, (opt_init, watched))
        with activation_sharding(mesh, policy), implicit_replication():
            p1, _, m1 = step1(dparams, opt_init(dparams), dbatch)
        out[f"{name}_adam/loss"] = _rel(m1["loss"], m0["loss"])
        out[f"{name}_adam/params_abs"] = _abs(p1, p0)
        out[f"{name}_adam/mismatch"] = seen["mismatch"]
        out[f"{name}_adam/counts"] = seen["counts"]


def _moe_counts(mesh, out):
    """The MoE layer alone (``moe_apply`` and its aux term), forward and
    backward: its collectives on this rank (the dry run's counter)."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun as D
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.sharding import dtensor_ops as dt
    from repro_torch.sharding.policy import (ShardingPolicy, act_spec,
                                             activation_sharding, sanitize,
                                             to_placements, tree_param_specs)
    policy = ShardingPolicy()
    for case in MOE_CASES:
        cfg = _tiny(case)
        g = torch.Generator().manual_seed(3)
        params = {"moe": T.init_block(cfg, "attn", g, "cpu")["moe"]}
        x = torch.randn(B, S, cfg.d_model, generator=g)
        dparams = _dist(mesh, params, tree_param_specs(mesh, policy, params))
        dx = distribute_tensor(x, mesh, to_placements(mesh, sanitize(
            mesh, x.shape, act_spec(mesh, policy, "resid_inner"))))
        dx.requires_grad_(True)
        with activation_sharding(mesh, policy), implicit_replication():
            p = T.tree_map(lambda t: t.detach().requires_grad_(True),
                           dt.fsdp_gather(dparams))["moe"]
            with D.OpCounter() as c:
                o, aux = M.moe_apply(p, dx, top_k=cfg.moe_top_k,
                                     capacity_factor=cfg.capacity_factor,
                                     mlp_variant=cfg.mlp_variant)
                term = T._moe_aux_loss(aux)
            fwd = (dict(c.collectives), dict(c.calls))
            grads = [distribute_tensor(torch.ones(t.shape), mesh,
                                       list(t.placements)) for t in (o, term)]
            with D.OpCounter() as c:
                torch.autograd.backward([o, term], grads)
            bwd = (dict(c.collectives), dict(c.calls))
        out[f"{case}/moe_counts"] = {"forward": fwd, "backward": bwd}


def _rank_body():
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    _ops(mesh, out)
    _lm(mesh, out)
    _split_lm(mesh, out)
    _branches(mesh, out)
    _rows_in(mesh, out)
    _decode_steps(mesh, out)
    _optimizer(mesh, out)
    _moe_counts(mesh, out)
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks():
    return tmesh.run_ranks(4, _rank_body, device_type="cpu", timeout=600)


VALUES = ["embedding/value", "embedding/grad", "pad/value",
          "write_slot/2", "write_slot/13", "decode_over_shards/5",
          "decode_over_shards/13", "decode_over_shards/24",
          "local_heads/value", "local_heads/grad", "train/loss",
          "train/grads", "adam_step/loss", "prefill/logits",
          "prefill/cache", "decode0/logits", "decode0/cache",
          "decode1/logits", "decode1/cache", "split_lm/loss",
          "split_lm/grads", "rows_in/value", "rows_in/grads"] + [
    f"{case}/{part}" for case in list(MOE_CASES) + list(RECURRENT_CASES)
    for part in (("attn/value", "attn/aux", "attn/grads")
                 if case in MOE_CASES else
                 ("mlstm/value", "mlstm/aux", "mlstm/grads")
                 + (("slstm/value", "slstm/aux", "slstm/grads")
                    if case == "mlstm_split" else ()))
    + ("lm/loss", "lm/grads")] + [
    f"{case}/{kind}_step/b{b}/{part}" for case in RECURRENT_CASES
    for kind in (("mlstm", "slstm") if case == "mlstm_split" else ("mlstm",))
    for b in STEP_BATCHES for part in ("value", "state", "grads")] + [
    f"{case}/decode{i}/{part}" for case in RECURRENT_CASES for i in range(2)
    for part in ("logits", "cache")] + [
    f"{name}_adam/loss" for name in ("xlstm", "granite")]


@pytest.mark.parametrize("key", VALUES)
def test_dtensor_path_matches_plain(ranks, key):
    for r, out in enumerate(ranks):
        assert out[key] <= REL_TOL, (r, key, out[key])


@pytest.mark.parametrize("key", ["adam_step", "xlstm_adam",
                                 "granite_adam"])
def test_adam_step_within_its_bound(ranks, key):
    for r, out in enumerate(ranks):
        assert out[f"{key}/params_abs"] <= ADAM_TOL, (r, key, out)


@pytest.mark.parametrize("key", ["embedding/partial", "pad/layout_kept",
                                 "local_heads/layout_kept",
                                 "split_lm/rank_rows"])
def test_own_branch_taken(ranks, key):
    assert all(out[key] == 1.0 for out in ranks), key


def test_model_takes_the_rank_local_branches(ranks):
    for out in ranks:
        # 2 layers x (a loss, an Adam step's loss, a prefill)
        assert out["taken/local_heads"] >= 6
        # 2 layers x 2 decode steps
        assert out["taken/decode_over_shards"] == 4


@pytest.mark.parametrize("case", list(MOE_CASES) + list(RECURRENT_CASES))
def test_rank_local_branch_in_every_layer(ranks, case):
    """Each layer alone takes its branch once; the tiny LM's train step
    takes it in each of its layers (MoE: one per block; xLSTM: the
    sLSTM and mLSTM blocks), twice over: the forward and the
    recomputation of its checkpointed super-block in the backward."""
    layers = 2
    kinds = (("attn",) if case in MOE_CASES else
             ("slstm", "mlstm") if case == "mlstm_split" else ("mlstm",))
    for out in ranks:
        for kind in kinds:
            assert out[f"taken/{case}/{kind}"] == 1.0, (case, kind)
        if case in RECURRENT_CASES:
            # the mLSTM's output projection on each rank's shards
            assert out[f"taken/{case}/heads_out"] == 1.0, case
            # the sLSTM's output gate: once alone, and in the tiny LM's
            # one sLSTM layer, forward and recomputation
            if case == "mlstm_split":
                assert out[f"taken/{case}/rows_in"] == 1.0, case
            assert out[f"taken/{case}/lm_rows_in"] == 2.0, case
        else:
            assert out[f"taken/{case}/lm_rows_in"] == 0.0, case
        assert out[f"taken/{case}/lm"] == 2 * layers, case


@pytest.mark.parametrize("key", ["experts", "recurrence", "decode"])
def test_no_dtensor_op_inside_the_loops(ranks, key):
    """No DTensor operation runs inside the expert einsums (``route``,
    ``expert_ffn``), a recurrence's steps (``_mlstm_cell``,
    ``_slstm_cell``) or the decode steps' cells on the mesh: their
    inputs are each rank's own shards, whatever DTensor's view rules of
    the torch version."""
    for out in ranks:
        assert out["inner/control/dtensor_ops"] >= 1.0
        assert out[f"inner/{key}/calls"] > 0, key
        assert out[f"inner/{key}/dtensor_ops"] == 0.0, key


@pytest.mark.parametrize("phase,flops,collectives", [
    # [B/2, S, D/2] @ [D/2, H]: the partial sums reduce-scattered over
    # the model axis onto the gates' split of H, [B/2, S, H/2] float32
    ("forward", 2 * (B // 2) * S * 16 * 16,
     {"reduce-scatter": ((B // 2) * S * 8 * 4, 1)}),
    # the gradient all-gathered whole along H ([B/2, S, H]); x's
    # gradient stays a partial sum over the model axis, as the other
    # gates' are; the two local products of the forward's size
    ("backward", 2 * 2 * (B // 2) * S * 16 * 16,
     {"all-gather": ((B // 2) * S * 16 * 4, 1)})])
def test_rows_in_counts(ranks, phase, flops, collectives):
    """The sLSTM's output gate on the ranks' shards (``rows_in``), on a
    (data 2, model 2) mesh at d_model 32, d_rnn 16 with its weight split
    along d_model: per rank, the FLOPs and collectives that the dry
    run's counter records, exactly, and the gates' layout; on torch
    2.11 DTensor's own rules instead all-reduced a whole ``[B, S, H]``
    and contracted the weight's gradient whole (PERF.md)."""
    for out in ranks:
        assert out["rows_in/layout"]
        got_flops, got_bytes, got_calls = out["rows_in/counts"][phase]
        assert got_flops == flops
        assert {k: (got_bytes[k], got_calls[k]) for k in got_bytes} == \
            collectives


@pytest.mark.parametrize("case", list(RECURRENT_CASES))
def test_decode_step_on_the_ranks_shards(ranks, case):
    """The one-step branch (``dtensor_ops.local_step``) is taken by every
    decode step alone, at batch 4 (rows split over the data axis) and at
    batch 1 (whole on it, the layout of long_500k, where DTensor's own
    rules are what it replaces), and in each recurrent layer of the tiny
    xLSTM's decode: 2 layers x 2 tokens."""
    kinds = ("mlstm", "slstm") if case == "mlstm_split" else ("mlstm",)
    for out in ranks:
        for kind in kinds:
            for b in STEP_BATCHES:
                assert out[f"taken/{case}/{kind}_step/b{b}"] == 1.0, (kind, b)
        assert out[f"taken/{case}/decode"] == 4.0, case


@pytest.mark.parametrize("case,flops,collectives", [
    # 3 heads stay whole on the 2-way model axis, as xlstm-350m's 4 do on
    # its 8-way one: per rank its 2 rows, every head. q/k/v/o: 4 x 2 x 2
    # x 32 x (3 x 8); the gates 2 x 2 x 32 x (3 x 2); the cell's outer
    # product and C q: 2 x 2 x 2 x 3 x 8 x 8, n q: 2 x 2 x 3 x 8; the
    # output projection on the rank's half of hd: 2 x 2 x 3 x 4 x 32,
    # its partial sums all-reduced over the model axis ([2, 1, 32]
    # float32); the state is written as the cache holds it
    ("mlstm_whole", 4 * 2 * 2 * 32 * 24 + 2 * 2 * 32 * 6
     + 2 * (2 * 2 * 3 * 64) + 2 * 2 * 3 * 8 + 2 * 2 * 3 * 4 * 32,
     {"all-reduce": (2 * 32 * 4, 1)}),
    # 4 heads split 2 ways: per rank 2 rows x 2 heads; the gates' weight
    # whole (every head, then the rank's slice); the output projection
    # takes the weight split by heads (on a CPU mesh an all-to-all runs
    # as an all-gather of the whole [4, 8, 32] float32 weight)
    ("mlstm_split", 4 * 2 * 2 * 32 * 16 + 2 * 2 * 32 * 8
     + 2 * (2 * 2 * 2 * 64) + 2 * 2 * 2 * 8 + 2 * 2 * 2 * 8 * 32,
     {"all-gather": (4 * 8 * 32 * 4, 1), "all-reduce": (2 * 32 * 4, 1)})])
def test_mlstm_step_counts(ranks, case, flops, collectives):
    """One mLSTM decode step on a (data 2, model 2) mesh at d_model 32,
    hd 8, batch 4: per rank, the FLOPs and collectives that the dry
    run's counter records, exactly. The projections run on the rank's
    rows with the heads' split of their weights, the cell on the rank's
    rows and heads (``dtensor_ops.local_step``), the output projection
    on its shards (``heads_out``). On torch 2.11 DTensor's own rules
    ran the cell's products on partial sums and all-reduced the state
    inside it; 2.13's at the cache write (PERF.md)."""
    for out in ranks:
        got_flops, got_bytes, got_calls = out[f"{case}/mlstm_step/counts"]
        assert got_flops == flops
        assert {k: (got_bytes[k], got_calls[k]) for k in got_bytes} == \
            collectives


@pytest.mark.parametrize("name,collectives", [
    # groups by the mesh dims that split a parameter: whole (the norms),
    # split over both axes: 2 all-reduces of one float32 each
    ("granite", {"all-reduce": (2 * 4, 2)}),
    # and over the data axis alone (the mLSTM's 3 heads whole on the
    # model axis) and the model axis alone (the sLSTM's ``w_o``): 4
    ("xlstm", {"all-reduce": (4 * 4, 4)})])
def test_optimizer_sees_the_parameters_layout(ranks, name, collectives):
    """The tiny LMs' train step on the mesh: every gradient reaches
    Adam with its parameter's placements (``dtensor_ops.to_param_layout``
    reduce-scatters or all-reduces the partial sums autograd leaves), so
    the update's elementwise ops run on the parameters' shards with no
    collective; the global norm sums each rank's shards and all-reduces
    one float32 per mesh dim of each group of parameters split alike
    (``dtensor_ops.sum_squares``). Per rank, exactly. On torch 2.11
    DTensor's own rules all-reduced the partial gradients whole inside
    the update (51.2 MB per card on xlstm-350m's train_4k), on 2.13 they
    reduce-scattered them (PERF.md)."""
    for out in ranks:
        assert out[f"{name}_adam/mismatch"] == [], out[f"{name}_adam/mismatch"]
        got_bytes, got_calls = out[f"{name}_adam/counts"]
        assert {k: (got_bytes[k], got_calls[k]) for k in got_bytes} == \
            collectives


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("phase,collectives", [
    # the experts' partial outputs reduce-scattered onto the residual's
    # sequence split ([2, 4, 32] float32); the batch means of the top-1
    # choices and of the probabilities whole ([E] float32 each), and
    # the z-loss where the aux term takes it (one float32)
    ("forward", lambda E: {"reduce-scatter": (2 * 4 * 32 * 4, 1),
                           "all-reduce": (2 * E * 4 + 4, 3)}),
    # the output's gradient gathered whole along the sequence ([2, 8,
    # 32]); the gates' gradient, partial over the model axis, summed in
    # their layout ([2, 8, 2]); the tokens' gradient from the experts
    # reduce-scattered onto the residual's split, where the router's
    # (whole) takes its slice without a collective
    ("backward", lambda E: {"all-gather": (2 * 8 * 32 * 4, 1),
                            "all-reduce": (2 * 8 * 2 * 4, 1),
                            "reduce-scatter": (2 * 4 * 32 * 4, 1)})])
def test_moe_layer_counts(ranks, case, phase, collectives):
    """The MoE layer (``moe_apply`` and ``transformer._moe_aux_loss``) on
    a (data 2, model 2) mesh at d_model 32, batch 4 x 8 tokens, top-2
    of 4 experts (expert parallel) or 3 (``d_ff`` split): per rank, the
    collectives the dry run's counter records, exactly. The layout of
    every gradient the router and the aux losses meet is named
    (``dtensor_ops.grad_as_resid``, ``keep_grad_layout``, ``whole``,
    ``local_rows`` for the top-k); on torch 2.11 DTensor's own rules
    instead gathered the whole batch's scores for the sort's backward
    (PERF.md)."""
    E = MOE_CASES[case]
    for out in ranks:
        got_bytes, got_calls = out[f"{case}/moe_counts"][phase]
        assert {k: (got_bytes[k], got_calls[k]) for k in got_bytes} == \
            collectives(E), (case, phase)
