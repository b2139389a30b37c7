"""The port's client-sharded training step on gloo ranks on the CPU,
against the port's unsharded step and the JAX package's.

One module-scoped spawn of 4 ranks (``launch.mesh.run_ranks``); meshes
of 1, 2 and 4 ranks are carved from it. The parent computes the
reference's draws and results with JAX and hands numpy to the ranks,
which import no JAX; every rank returns what it measured, and the
parent holds it to the tolerances. This module imports no JAX at the
top: the ranks import it for their bodies.

Tolerances:
* the reference's own sharded test (``tests/test_train_fused.py``,
  ``_check_fused_epoch_sharded``): after 2 fused steps on 2 devices the
  EMA within 1e-3 of the unsharded trainer, the state within 0.05, and
  after a round the client state within 0.05 again;
* against the port's unsharded step on the same draws: one step's
  losses and EMA within 1e-5 (the server's BatchNorm statistics and the
  losses are sums over the ranks, in another order); after N steps the
  parameters within Adam's bound 2 N lr (a first Adam step moves a
  parameter by about lr whatever its gradient's size, so a gradient that
  changes sign in its last bits moves it by 2 lr: ``tests/
  test_torch_slice.py``);
* rounds on a rank's own rows: 1e-6 dense, 1e-5 chunked, as the
  row-block sharded rounds (``tests/test_torch_mesh.py``);
* the server's replicas, a 1-rank mesh against no mesh, a checkpoint
  round trip, ``generate`` and a regroup from one state: bit for bit;
* the sharded step's fused epoch (its CPU route) against the per-step
  loop: as the unsharded step above; the shared all-reduce's plain
  version against the rank-order float32 numpy sum: bit for bit, and
  within 1e-6 of the summed magnitudes of gloo's all_reduce (which adds
  in another order).
"""
import dataclasses
import functools
import hashlib
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

LR = 2e-4
STEP_TOL = 1e-5
SHARD_TOL = 1e-6
CHUNK_TOL = 1e-5
REF_EMA_TOL = 1e-3
REF_STATE_TOL = 0.05
RANKS = (1, 2, 4)


# ---------------------------------------------------------------------------
# helpers shared by the parent and the ranks (no JAX)
# ---------------------------------------------------------------------------

def _population(lat, part, n_clients, n_devices=2, base_size=12):
    """``2dom_iid`` clients on ``PAPER_DEVICES[i % n_devices]`` with
    alternating cuts: 2 devices give 2 groups of ``n_clients / 2``; 3
    give the smoke's slice grouping (sizes 2, 2, 1, 1, 1, 1 at 8
    clients)."""
    clients = part.build_scenario("2dom_iid", num_clients=n_clients,
                                  base_size=base_size, seed=0)
    devices = [lat.PAPER_DEVICES[i % n_devices] for i in range(n_clients)]
    cuts = [lat.Cut(1, 3, 1, 3) if i % 2 == 0 else lat.Cut(2, 4, 2, 4)
            for i in range(n_clients)]
    return clients, devices, cuts


def _config(cls, **kw):
    base = dict(batch=2, steps_per_epoch=1, federate_every=10 ** 6, seed=0,
                lr=LR)
    base.update(kw)
    return cls(**base)


def _max_diff(a, b) -> float:
    la, lb = list(tree_items(a)), list(tree_items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    return max((float(np.abs(np.asarray(x, np.float64)
                             - np.asarray(y, np.float64)).max())
                for (_, x), (_, y) in zip(la, lb)), default=0.0)


def _carry(tr):
    from repro_torch.core.huscf import _carry_items
    return _carry_items(tr.state)


def _bits_equal(a_items, b_items) -> bool:
    """Equal leaves, bit for bit; an Adam step may be an int on one side
    (after a ``bridge`` load) and a 0-dim tensor on the other."""
    def same(x, y):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            return x.dtype == y.dtype and torch.equal(x, y)
        return int(x) == int(y)
    return len(a_items) == len(b_items) and all(
        p == q and same(x, y) for (p, x), (q, y) in zip(a_items, b_items))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _server_digest(tr) -> str:
    """The server's parameters and Adam moments, bit for bit."""
    return _digest([x for p, x in _carry(tr) if "server" in p[1:3]])


def _client_rows(tr) -> set:
    """Leading sizes of every client stack (parameters and moments)."""
    return {(p[2] if p[1] == "client" else p[3], int(x.shape[0]))
            for p, x in _carry(tr) if tr._is_rows(p)}


def _client_state(whole) -> dict:
    return {net: state_to_numpy(whole[net]["client"]) for net in ("G", "D")}


# ---------------------------------------------------------------------------
# rank bodies (run in spawned ranks; no JAX)
# ---------------------------------------------------------------------------

def _twin_of_reference(init_np, batches, out):
    """(a): the reference's 4 clients on a 2-rank mesh, fused epoch
    (its CPU stand-in), fed the reference's draws and initial state."""
    from repro_torch.core import huscf as H
    from repro_torch.core import latency as L
    from repro_torch.data import partition as P
    mesh = tmesh.make_federation_mesh(2, "cpu")
    if not tmesh.in_mesh(mesh):
        return
    clients, devices, cuts = _population(L, P, 4, base_size=16)
    it = iter(batches)
    tr = H.HuSCFTrainer(
        clients, devices, cuts=cuts, device="cpu", fed_mesh=mesh,
        config=_config(H.HuSCFConfig, steps_per_epoch=2),
        batch_source=lambda: {f: {g: torch.tensor(a) for g, a in d.items()}
                              for f, d in next(it).items()})
    tr.load_whole_state(state_from_numpy(init_np, "cpu"))
    images = {g: tuple(x.shape) for g, x in tr._dataset.images.items()}
    losses = tr.train_steps(2)
    ema = tr.middle_activations()
    state = state_to_numpy(tr.whole_state())
    diag = tr.federate()
    out["twin"] = {"sharded": tr.step_sharded, "images": images,
                   "losses": losses, "ema": ema, "state": state,
                   "mode": diag["mode"],
                   "round": _client_state(tr.whole_state())}


def _count_k1(log):
    """Record the shapes of K1's calls (its plain version on the CPU)."""
    from repro_torch.kernels import weighted_agg as wa
    fn = wa.clustered_agg_flat

    def run(w, theta, *a, **k):
        log.append((tuple(w.shape), tuple(theta.shape)))
        return fn(w, theta, *a, **k)
    wa.clustered_agg_flat = run


def _clients(tr, whole: bool) -> dict:
    """Both nets' client parameters, {net: {gname: tree}}: this rank's
    rows, or with ``whole`` every rank's (one gather, no moments)."""
    from repro_torch.tree import tree_from_items
    items = [(p, x) for p, x in _carry(tr)
             if p[0] in ("G", "D") and p[1] == "client"]
    if whole:
        items = tmesh.gather_state(items, tr.fed_mesh, tr._shard_axes,
                                   lambda p: True)
    t = tree_from_items(items)
    return {net: t[net]["client"] for net in ("G", "D")}


def _torch_diff(a, b) -> float:
    la, lb = list(tree_items(a)), list(tree_items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    return max(float((x - y).abs().max()) for (_, x), (_, y) in zip(la, lb))


def _expected_round(tr, before, diag, chunk=None):
    """This rank's rows of the unsharded round of ``diag``'s weights and
    labels on the whole client parameters ``before``."""
    from repro_torch.core.clustering import k_selection_bound
    from repro_torch.core.federation import (N_LAYERS, fedavg_uniform,
                                             federate_client_params,
                                             federate_client_params_device)
    mask = None
    if "cohort" in diag:
        mask = tr.registry.cohort_mask(diag["cohort"])
    want = {}
    for net in ("G", "D"):
        wrapped = {g.name: {net: before[net][g.name]} for g in tr.groups}
        kw = dict(n_layers={net: N_LAYERS[net]}, use_kernel=True,
                  chunk_size=chunk)
        if diag["mode"] == "fedavg":
            got = fedavg_uniform(tr.groups, wrapped, tr.sizes, **kw)
        elif isinstance(diag["weights"], np.ndarray):    # the host round
            got = federate_client_params(tr.groups, wrapped, diag["weights"],
                                         diag["labels"], **kw)
        else:
            got = federate_client_params_device(
                tr.groups, wrapped, diag["weights"], diag["labels"],
                k_selection_bound(len(tr.clients), tr.cfg.num_clusters),
                cohort_mask=mask,
                cohort_size=None if mask is None else int(mask.sum()), **kw)
        want[net] = {g.name: _rows_of(got[g.name][net],
                                         tr._blocks[g.name])
                     for g in tr.groups}
    return want


def _rows_of(tree, block):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x[slice(*block)], tree)


def _rounds(tr, out, k1_log):
    """(c): FedAvg, clustered, chunked, cohort and host label-KLD rounds
    of a sharded trainer, each against the unsharded round from its
    input."""
    from repro_torch.core.federation import get_federation_plan
    syncs = []
    tr.sync_replicas = lambda mesh: syncs.append(mesh)
    rounds = []
    for name, chunk, cohort in (("fedavg", None, None),
                                ("clustered", None, None),
                                ("chunked", 2, None),
                                ("cohort", None, 4),
                                ("host", None, None)):
        tr.cfg = dataclasses.replace(tr.cfg, agg_chunk=chunk,
                                     cohort_size=cohort)
        before = _clients(tr, whole=True)
        del k1_log[:]
        diag = tr.federate(use_label_kld=name == "host")
        rounds.append({"name": name, "mode": diag["mode"],
                       "k1": list(k1_log),
                       "diff": _torch_diff(_clients(tr, whole=False),
                                           _expected_round(tr, before, diag,
                                                           chunk))})
    plans = list(tr._fed_plans.values())
    dense = [p for p in plans if p.chunk_size is None and p.net == "G"][0]
    unsharded = get_federation_plan(tr.groups, "G", 5, before["G"], {})
    out["rounds"] = {"rounds": rounds, "syncs": len(syncs),
                     "local": all(p.local_rows for p in plans),
                     "buffer": (dense.dense_buffer_bytes(),
                                unsharded.dense_buffer_bytes())}


def _against_unsharded(out, k1_log):
    """(b), then (c) on the 2- and 4-rank trainers: 8 clients in 2 groups
    of 4 on meshes of 1, 2 and 4 ranks against the unsharded trainer."""
    from repro_torch.core import huscf as H
    from repro_torch.core import latency as L
    from repro_torch.data import partition as P
    clients, devices, cuts = _population(L, P, 8)

    def make(mesh, **kw):
        return H.HuSCFTrainer(clients, devices, cuts=cuts, device="cpu",
                              fed_mesh=mesh,
                              config=_config(H.HuSCFConfig,
                                             warmup_fed_rounds=1, **kw))

    twin = make(None)
    first = twin.train_steps(1)
    twin_ema = twin.middle_activations()
    twin.train_steps(2)
    for n in RANKS:
        mesh = tmesh.make_federation_mesh(n, "cpu")
        if not tmesh.in_mesh(mesh):
            continue
        tr = make(mesh)
        got = tr.train_steps(1)
        ema = tr.middle_activations()
        rec = {"sharded": tr.step_sharded,
               "images": sorted(int(x.shape[0])
                                for x in tr._dataset.images.values()),
               "client_rows": _client_rows(tr), "ema_rows":
               int(tr._mid_ema.shape[0]),
               "loss_diff": max(abs(got[k] - first[k]) for k in got),
               "ema_diff": float(np.abs(ema - twin_ema).max())}
        tmesh.calls.clear()
        tr.train_steps(2)
        rec["calls_per_step"] = {k: v / 2 for k, v in tmesh.calls.items()}
        params = tmesh.gather_state(
            [(p, x) for p, x in _carry(tr) if p[0] in ("G", "D")],
            tr.fed_mesh, tr._shard_axes, tr._is_rows)
        rec["param_diff"] = _torch_diff(
            dict(params), dict((p, x) for p, x in _carry(twin)
                               if p[0] in ("G", "D")))
        rec["server"] = _server_digest(tr)
        if n == 1:
            rec["equal_unsharded"] = _bits_equal(_carry(tr), _carry(twin)) \
                and torch.equal(tr._mid_ema, twin._mid_ema)
        else:
            _rounds(tr, rec, k1_log)
        out[("b", n)] = rec


def _executors(out):
    """(d): a sharded ``split_program=False`` trainer's step, and both
    executors with ``concat_groups`` True and False on a rank's rows
    against the whole batch, forward and backward."""
    from repro_torch.core import huscf as H
    from repro_torch.core import latency as L
    from repro_torch.data import partition as P
    from repro_torch.models.gan import Z_DIM
    mesh = tmesh.make_federation_mesh(2, "cpu")
    if not tmesh.in_mesh(mesh):
        return
    clients, devices, cuts = _population(L, P, 8)
    pair = [H.HuSCFTrainer(clients, devices, cuts=cuts, device="cpu",
                           fed_mesh=m,
                           config=_config(H.HuSCFConfig, split_program=False,
                                          fused_epoch=False))
            for m in (mesh, None)]
    got, want = (tr.train_steps(1) for tr in pair)
    out["legacy"] = {
        "sharded": pair[0].step_sharded,
        "loss_diff": max(abs(got[k] - want[k]) for k in got),
        "ema_diff": float(np.abs(pair[0].middle_activations()
                                 - pair[1].middle_activations()).max())}

    sharded, whole = pair
    rng = np.random.default_rng(5)
    inputs = {g.name: (torch.tensor(rng.normal(size=(g.size, 2, Z_DIM)),
                                    dtype=torch.float32),
                       torch.tensor(rng.integers(0, 10, (g.size, 2)),
                                    dtype=torch.int32))
              for g in whole.groups}
    proj = {g.name: torch.tensor(rng.normal(size=(g.size, 2, 28, 28, 1)),
                                 dtype=torch.float32) for g in whole.groups}
    blocks = sharded._blocks
    reduce = functools.partial(tmesh.reduce_sum, mesh=mesh,
                               axes=sharded._shard_axes)
    for build in (H.build_net_apply, H.build_net_apply_legacy):
        for concat in (True, False):
            runs = []
            for groups, red, cut in ((sharded._step_groups, reduce, True),
                                     (whole.groups, None, False)):
                params = H.tree_map(
                    lambda x: x.detach().requires_grad_(True),
                    whole.state["G"])
                apply = build(groups, "G", concat_groups=concat, reduce=red)
                take = (lambda t, g: t[slice(*blocks[g])]) if cut else \
                    (lambda t, g: t)
                ins = {g: (take(z, g), take(y, g))
                       for g, (z, y) in inputs.items()}
                # each rank's client params are its rows of the whole
                client = {g: H.tree_map(lambda x, g=g: take(x, g), c)
                          for g, c in params["client"].items()}
                outs, _, new_server, _ = apply(client, params["server"], ins,
                                               True)
                loss = sum((outs[g] * take(proj[g], g)).sum() for g in outs)
                leaves = [x for _, x in tree_items(params)]
                grads = dict(zip([p for p, _ in tree_items(params)],
                                 torch.autograd.grad(
                                     loss, leaves, allow_unused=True)))
                runs.append((outs, new_server, grads))
            (o_s, srv_s, g_s), (o_w, srv_w, g_w) = runs
            server_g = [g_s[p] for p in sorted(g_s) if p[0] == "server"
                        and g_s[p] is not None]
            tmesh.all_reduce_flat(server_g, mesh, sharded._shard_axes)
            diff = {"out": max(float((o_s[g] - o_w[g][slice(*blocks[g])])
                                     .detach().abs().max()) for g in o_s),
                    "stats": _max_diff(
                        {k: v.detach() for k, v in tree_items(srv_s)},
                        {k: v.detach() for k, v in tree_items(srv_w)}),
                    "server_grad": 0.0, "client_grad": 0.0, "scale": 0.0}
            for p in g_w:
                if g_w[p] is None or p[-1] in ("mean", "var"):
                    continue
                if p[0] == "server":
                    d = (g_s[p] - g_w[p]).abs().max()
                else:
                    rows = slice(*blocks[p[1]])
                    d = (g_s[p][rows] - g_w[p][rows]).abs().max()
                key = "server_grad" if p[0] == "server" else "client_grad"
                diff[key] = max(diff[key], float(d))
                diff["scale"] = max(diff["scale"], float(g_w[p].abs().max()))
            out[("executor", build.__name__, concat)] = diff


class _Searcher:
    """A search that finds the cuts it is given."""

    def __init__(self, cuts):
        self.cuts = cuts

    def run(self, gen):
        return None

    def to_result(self, _):
        return types.SimpleNamespace(cuts=list(self.cuts), latency=1.0)


def _whole_state_paths(ckpt, out):
    """(e) checkpoint, generate and a regroup in and out of the sharded
    mode, each from one state against the unsharded trainer; (f) a
    grouping that does not divide."""
    from repro_torch.core import huscf as H
    from repro_torch.core import latency as L
    from repro_torch.data import partition as P
    mesh = tmesh.make_federation_mesh(2, "cpu")
    if not tmesh.in_mesh(mesh):
        return
    clients, devices, cuts = _population(L, P, 8)

    def make(m, devs=devices):
        return H.HuSCFTrainer(clients, devs, cuts=cuts, device="cpu",
                              fed_mesh=m,
                              config=_config(H.HuSCFConfig,
                                             fused_epoch=False))

    tr, twin = make(mesh), make(None)
    tr.train_steps(1)
    twin.load_whole_state(tr.whole_state(),
                          torch.from_numpy(tr.middle_activations()))
    rec = {}
    tr.save_checkpoint(ckpt)
    back = make(mesh)
    rec["ckpt_step"] = back.load_checkpoint(ckpt)
    rec["ckpt_equal"] = _bits_equal(_carry(back), _carry(tr))
    rec["ckpt_rows"] = _client_rows(back) == _client_rows(tr)
    labels = np.arange(11) % 10
    img_s, lab_s = tr.generate(2, labels)
    img_w, lab_w = twin.generate(2, labels)
    rec["generate"] = (img_s.shape, bool(np.array_equal(img_s, img_w)),
                       bool(np.array_equal(lab_s, lab_w)),
                       tr.step_sharded)
    # client 0 reports a profile of its own: a group of 1, which no mesh
    # divides, so the step replicates; then back to its old profile
    alone = dataclasses.replace(devices[0], name="drifted")
    modes = []
    for cid, prof, new_cuts in ((0, alone, cuts), (0, devices[0], cuts)):
        for t in (tr, twin):
            t._get_searcher = lambda devs=None, c=new_cuts: _Searcher(c)
            t.update_profile(cid, prof)
        modes.append((tr.step_sharded,
                      sorted(int(x.shape[0])
                             for x in tr._dataset.images.values()),
                      _bits_equal(H._carry_items(tr.whole_state()),
                                  _carry(twin)),
                      bool(np.array_equal(tr.middle_activations(),
                                          twin.middle_activations()))))
    rec["regroup"] = modes
    out["whole"] = rec

    # (f) the slice grouping (sizes 2, 2, 1, 1, 1, 1) does not divide
    c3, d3, k3 = _population(L, P, 8, n_devices=3)
    rep = H.HuSCFTrainer(c3, d3, cuts=k3, device="cpu", fed_mesh=mesh,
                         config=_config(H.HuSCFConfig, fused_epoch=False))
    syncs = []
    sync = rep.sync_replicas
    rep.sync_replicas = lambda m: (syncs.append(m), sync(m))
    rep.train_steps(1)
    rep.federate()
    out["replicated"] = {
        "sharded": rep.step_sharded,
        "images": sorted(int(x.shape[0]) for x in rep._dataset.images.values()),
        "rows": sorted(n for _, n in _client_rows(rep)),
        "syncs": len(syncs), "ema_rows": int(rep._mid_ema.shape[0]),
        "plans": [p.local_rows for p in rep._fed_plans.values()]}


def _fused_sharded(out):
    """(g) the sharded step's fused epoch on the CPU route (the plain
    rank-order sum the card's kernel computes) against the per-step gloo
    loop, both from the seed's state and draws, on 2 and 4 ranks."""
    from repro_torch.core import huscf as H
    from repro_torch.core import latency as L
    from repro_torch.data import partition as P
    clients, devices, cuts = _population(L, P, 8)
    for n in RANKS[1:]:
        mesh = tmesh.make_federation_mesh(n, "cpu")
        if not tmesh.in_mesh(mesh):
            continue
        runs = {}
        for fused in (False, True):
            tr = H.HuSCFTrainer(clients, devices, cuts=cuts, device="cpu",
                                fed_mesh=mesh,
                                config=_config(H.HuSCFConfig,
                                               fused_epoch=fused))
            tmesh.calls.clear()
            first = tr.train_steps(1)
            calls = dict(tmesh.calls)
            ema = tr.middle_activations()
            tr.train_steps(2)
            params = tmesh.gather_state(
                [(p, x) for p, x in _carry(tr) if p[0] in ("G", "D")],
                tr.fed_mesh, tr._shard_axes, tr._is_rows)
            runs[fused] = {"losses": first, "calls": calls, "ema": ema,
                           "params": dict(params),
                           "server": _server_digest(tr), "tr": tr}
        loop, graph = runs[False], runs[True]
        coll = graph["tr"]._graph_coll
        out[("fused", n)] = {
            "sharded": graph["tr"].step_sharded,
            "route": dict(coll.routes),
            "loss_diff": max(abs(graph["losses"][k] - loop["losses"][k])
                             for k in loop["losses"]),
            "ema_diff": float(np.abs(graph["ema"] - loop["ema"]).max()),
            "param_diff": _torch_diff(graph["params"], loop["params"]),
            "server": graph["server"],
            "calls": (loop["calls"], graph["calls"]),
            "messages": sum(coll.shared["data"].sizes.values())}


def _plain_sum(out):
    """The plain version of the shared all-reduce on 2 and 4 ranks: odd
    and 16-float sizes, against the rank-order numpy sum and gloo's
    all_reduce."""
    import torch.distributed as dist
    from repro_torch.kernels import shared_allreduce as sa
    rank = dist.get_rank()
    for n in RANKS[1:]:
        mesh = tmesh.make_federation_mesh(n, "cpu")
        if not tmesh.in_mesh(mesh):
            continue
        group = mesh.get_group("data")
        sar = sa.SharedAllReduce(group, "cpu")
        rec = {}
        for size in (1, 16, 1001):
            parts = [np.random.default_rng((size, q)).normal(
                0, 10.0 ** (q - 2), size).astype(np.float32)
                for q in range(n)]
            want = parts[0].copy()
            for p in parts[1:]:
                want = want + p                # float32, rank order
            got = sa.plain_all_reduce(torch.from_numpy(parts[rank].copy()),
                                      group)
            again = sar.all_reduce(torch.from_numpy(parts[rank].copy()))
            ref = torch.from_numpy(parts[rank].copy())
            dist.all_reduce(ref, group=group)
            scale = np.abs(np.stack(parts)).sum(0)
            rec[size] = {
                "bits": bool(np.array_equal(got.numpy(), want)
                             and np.array_equal(again.numpy(), want)),
                "gloo": float((np.abs(got.numpy() - ref.numpy())
                               / scale).max())}
        rec["release"] = sar.release() is None and sar.cap == 0
        out[("plain", n)] = rec


def _collectives(out):
    """The mesh module's collectives: no-ops on 1 rank; block order,
    inverse pairs and gradients on 2 and 4."""
    rank = torch.distributed.get_rank()
    for n in RANKS:
        mesh = tmesh.make_federation_mesh(n, "cpu")
        if not tmesh.in_mesh(mesh):
            continue
        x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
        y = torch.full((2,), float(rank), dtype=torch.float64)
        tmesh.calls.clear()
        gathered = tmesh.all_gather_rows([x, y], mesh, "data")
        kept = tmesh.keep_rows([(("a",), gathered[0]), (("b",), gathered[1])],
                               mesh, "data", lambda p: True)
        leaf = torch.ones(2, 3, requires_grad=True)
        summed = tmesh.reduce_sum(leaf * (rank + 1), mesh, "data")
        grad, = torch.autograd.grad(summed.sum(), [leaf])
        flat = [torch.full((2,), float(rank)), torch.full((1,), 1.0)]
        tmesh.all_reduce_flat(flat, mesh, "data")
        out[("coll", n)] = {
            "gathered": [g.tolist() for g in gathered],
            "same": gathered[0] is x and gathered[1] is y,
            "kept": [k.tolist() for _, k in kept],
            "summed": summed.tolist(), "grad": grad.tolist(),
            "flat": [f.tolist() for f in flat],
            "calls": dict(tmesh.calls)}
        tmesh.calls.clear()
        leaf64 = _terms64(rank).requires_grad_(True)
        summed64 = tmesh.reduce_sum(leaf64, mesh, "data")
        grad64, = torch.autograd.grad(
            (summed64 * torch.arange(1.0, 4.0, dtype=torch.float64)).sum(),
            [leaf64])
        out[("sum64", n)] = {"summed": summed64.tolist(),
                             "grad": grad64.tolist(),
                             "calls": dict(tmesh.calls)}


def _terms64(rank):
    """A rank's float64 terms, each wider than a float32 holds."""
    return (torch.tensor([1.0 / 3.0, 1e8 + 1.0 / 7.0, -2.0 ** -30],
                         dtype=torch.float64) * (rank + 1) + rank / 7.0)


def _rank_body(init_np, batches, ckpt):
    import torch.distributed as dist
    out = {"rank": dist.get_rank()}
    k1_log = []
    _count_k1(k1_log)
    _collectives(out)
    _twin_of_reference(init_np, batches, out)
    _against_unsharded(out, k1_log)
    _executors(out)
    _whole_state_paths(ckpt, out)
    _fused_sharded(out)
    _plain_sum(out)
    return out


# ---------------------------------------------------------------------------
# the parent: the reference's run, one spawn of 4 ranks
# ---------------------------------------------------------------------------

def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference_draws():
    """The reference's unsharded 4-client trainer of
    ``_check_fused_epoch_sharded``, started from the port's initial
    state: the trainer, that state and its draws for 2 fused steps."""
    import jax
    from test_torch_fused_epoch import reference_trainer
    from repro.core import huscf as jhuscf
    from repro.core import latency as jlat
    from repro.data import partition as jpart
    from repro_torch.core import huscf as H
    from repro_torch.core import latency as L
    from repro_torch.data import partition as P
    from repro_torch.optim.optimizers import AdamState as TAdam
    clients, devices, cuts = _population(L, P, 4, base_size=16)
    port = H.HuSCFTrainer(clients, devices, cuts=cuts, device="cpu",
                          config=_config(H.HuSCFConfig, steps_per_epoch=2))
    clients, devices, cuts = _population(jlat, jpart, 4, base_size=16)
    ref = reference_trainer(jhuscf.HuSCFTrainer, state_to_numpy(port.state),
                            clients, devices, cuts=cuts,
                            config=_config(jhuscf.HuSCFConfig,
                                           steps_per_epoch=2))
    # the ranks import no JAX: Adam's states cross as the port's tuple
    init = {k: (TAdam(*v) if isinstance(v, tuple) else v)
            for k, v in _np(ref.state).items()}
    key = jax.random.PRNGKey(1)
    sample = jax.jit(ref._sample)
    batches = []
    for _ in range(2):
        key, ks = jax.random.split(key)
        batches.append(_np(sample(ref._dataset, ks)))
    return ref, init, batches


def _reference_run(ref):
    """The reference's EMA and state after its 2 fused steps, and its
    client state after a round."""
    losses = ref.train_steps(2)
    ema, state = ref.middle_activations(), _np(ref.state)
    ref.federate()
    return {"losses": losses, "ema": ema, "state": state,
            "round": {net: _np(ref.state[net]["client"])
                      for net in ("G", "D")}}


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    """The reference's run (in this process) beside the 4 ranks' (spawned
    from a thread, which waits for them)."""
    from concurrent.futures import ThreadPoolExecutor
    ref, init, batches = _reference_draws()
    ckpt = os.path.join(str(tmp_path_factory.mktemp("step")), "s.ckpt")
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tmesh.run_ranks, 4, _rank_body, init, batches,
                            ckpt, device_type="cpu", timeout=600)
        want = _reference_run(ref)
        return want, ranks.result()


def _on(ranks, key):
    return [r[key] for r in ranks if key in r]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_twin_of_the_reference_sharded_epoch(step_ranks):
    """(a) The reference's ``_check_fused_epoch_sharded`` on the port: 4
    clients in 2 groups of 2 on 2 ranks, 2 fused steps from the
    reference's state and draws, then a round; each rank stages 1 row of
    each group."""
    ref, ranks = step_ranks
    twins = _on(ranks, "twin")
    assert len(twins) == 2
    for t in twins:
        assert t["sharded"] and t["mode"] == "fedavg"
        assert all(shape[0] == 1 for shape in t["images"].values())
        np.testing.assert_allclose(t["ema"], ref["ema"], atol=REF_EMA_TOL,
                                   rtol=0)
        assert _max_diff({k: t["state"][k] for k in ("G", "D")},
                         {k: ref["state"][k] for k in ("G", "D")}) \
            <= REF_STATE_TOL
        for opt in ("opt_g", "opt_d"):
            for f in ("mu", "nu"):
                assert _max_diff(getattr(t["state"][opt], f),
                                 getattr(ref["state"][opt], f)) \
                    <= REF_STATE_TOL
        assert _max_diff(t["round"], ref["round"]) <= REF_STATE_TOL
        for k in ("loss_d", "loss_g"):
            assert abs(t["losses"][k] - float(ref["losses"][k])) \
                <= 1e-2 * abs(float(ref["losses"][k]))


@pytest.mark.parametrize("n", RANKS)
def test_sharded_step_matches_unsharded(step_ranks, n):
    """(b) 8 clients in 2 groups of 4: one step's losses and EMA within
    1e-5 of the unsharded trainer on the same draws, 3 steps' parameters
    within 2 N lr; each rank holds K/n rows of the dataset, the client
    parameters, Adam's moments and the EMA; the server's replicas equal
    bit for bit; a 1-rank mesh is the unsharded trainer bit for bit."""
    _, ranks = step_ranks
    recs = _on(ranks, ("b", n))
    assert len(recs) == n
    for r in recs:
        assert r["sharded"] is (n > 1)
        assert r["images"] == [4 // n, 4 // n]
        assert {rows for _, rows in r["client_rows"]} == {4 // n}
        assert r["ema_rows"] == 8 // n
        assert r["loss_diff"] <= STEP_TOL and r["ema_diff"] <= STEP_TOL
        assert r["param_diff"] <= 2 * 3 * LR
    assert len({r["server"] for r in recs}) == 1
    if n == 1:
        assert recs[0]["equal_unsharded"]
        assert recs[0]["calls_per_step"] == {}
    else:
        # BatchNorm statistics forward and backward, the server's
        # gradients and the losses: all-reduces only, which a fused
        # epoch on the CPU runs as the plain rank-order sum (one gather
        # each)
        assert recs[0]["calls_per_step"] == {"all_gather": 57}


@pytest.mark.parametrize("n", RANKS[1:])
def test_rounds_on_local_rows(step_ranks, n):
    """(c) FedAvg, clustered, chunked, cohort and host label-KLD rounds
    of a sharded trainer within 1e-6 (chunked 1e-5) of the unsharded
    round from the same state, with no replica sync; the dense rounds
    run one K1 per net at [S, K/n] @ [K/n, D]; the rank's dense buffer
    is 1/n of the whole."""
    _, ranks = step_ranks
    for r in _on(ranks, ("b", n)):
        rd = r["rounds"]
        assert rd["syncs"] == 0 and rd["local"]
        assert rd["buffer"][0] * n == rd["buffer"][1]
        by = {x["name"]: x for x in rd["rounds"]}
        assert [by[k]["mode"] for k in ("fedavg", "clustered", "chunked",
                                        "cohort", "host")] == \
            ["fedavg", "clustered", "clustered", "clustered", "clustered"]
        for name, x in by.items():
            tol = CHUNK_TOL if name == "chunked" else SHARD_TOL
            assert x["diff"] <= tol, (name, x["diff"])
        for name in ("fedavg", "clustered", "cohort", "host"):
            assert len(by[name]["k1"]) == 2
            assert all(w[1] == t[0] == 8 // n for w, t in by[name]["k1"])
        # chunks of 2 over each group's 4 / n local rows, per net
        assert len(by["chunked"]["k1"]) == 2 * 2 * (-(-(4 // n) // 2))


def test_legacy_executor_sharded(step_ranks):
    """(d) ``split_program=False``: the sharded step within 1e-5 of the
    unsharded one."""
    _, ranks = step_ranks
    recs = _on(ranks, "legacy")
    assert len(recs) == 2
    for r in recs:
        assert r["sharded"]
        assert r["loss_diff"] <= STEP_TOL and r["ema_diff"] <= STEP_TOL


@pytest.mark.parametrize("build", ["build_net_apply",
                                   "build_net_apply_legacy"])
@pytest.mark.parametrize("concat", [True, False])
def test_executors_on_a_ranks_rows(step_ranks, build, concat):
    """(d) Both executors, concat and no-concat schedules, on a rank's
    rows with the server's statistics summed over 2 ranks: outputs, the
    server's new running statistics and the gradients (server summed
    over the ranks, the rank's client rows) within 1e-5 of the whole
    batch's."""
    _, ranks = step_ranks
    recs = _on(ranks, ("executor", build, concat))
    assert len(recs) == 2
    for d in recs:
        assert d["out"] <= STEP_TOL and d["stats"] <= STEP_TOL
        scale = max(1.0, d["scale"])
        assert d["server_grad"] <= STEP_TOL * scale
        assert d["client_grad"] <= STEP_TOL * scale


def test_checkpoint_and_generate_on_a_sharded_trainer(step_ranks):
    """(e) The first rank writes the gathered state; a fresh sharded
    trainer loads it, keeping its rows, bit for bit; ``generate`` on the
    gathered state equals the unsharded trainer's from the same state."""
    _, ranks = step_ranks
    recs = _on(ranks, "whole")
    assert len(recs) == 2
    for r in recs:
        assert r["ckpt_step"] == 0 and r["ckpt_equal"] and r["ckpt_rows"]
        shape, same_img, same_lab, sharded = r["generate"]
        assert shape == (11, 28, 28, 1) and same_img and same_lab and sharded


def test_regroup_moves_between_modes(step_ranks):
    """(e) ``update_profile`` gives client 0 a profile of its own (a group
    of 1: the step replicates, every rank stages every row), then takes
    it back (groups of 4: the step shards again); each regroup equals
    the unsharded trainer's from the same state, bit for bit."""
    _, ranks = step_ranks
    for r in _on(ranks, "whole"):
        (s1, img1, eq1, ema1), (s2, img2, eq2, ema2) = r["regroup"]
        assert not s1 and img1 == [1, 3, 4] and eq1 and ema1
        assert s2 and img2 == [2, 2] and eq2 and ema2


def test_non_divisible_grouping_stays_replicated(step_ranks):
    """(f) The slice grouping (sizes 2, 2, 1, 1, 1, 1) on 2 ranks:
    the step replicates, every rank holds every row, the round syncs the
    replicas first and shards the whole rows as before."""
    _, ranks = step_ranks
    recs = _on(ranks, "replicated")
    assert len(recs) == 2
    for r in recs:
        assert not r["sharded"] and r["syncs"] == 1
        assert r["images"] == [1, 1, 1, 1, 2, 2]
        assert r["rows"] and min(r["rows"]) >= 1 and r["ema_rows"] == 8
        assert r["plans"] and not any(r["plans"])


@pytest.mark.parametrize("backend,devices,route", [
    ("gloo", [None, None], "plain"),
    ("gloo", [0, 0, 0, 0], "kernel"),
    ("nccl", [0, 1], "nccl"),
    ("gloo", [0, 1], None),
    ("gloo", [0, None], None)])
def test_graph_route_by_backend_and_devices(backend, devices, route):
    """(g) The fused epoch's route for a sharded step's all-reduces: the
    plain rank-order sum on the CPU, the shared all-reduce kernel for
    gloo ranks on one card, NCCL with a GPU per rank; gloo ranks on
    several cards (and a mesh half on the CPU) raise, naming
    ``--per-step``."""
    if route is not None:
        assert tmesh.graph_route(backend, devices) == route
        return
    with pytest.raises(ValueError) as e:
        tmesh.graph_route(backend, devices)
    if None not in devices:
        assert "--per-step" in str(e.value)


@pytest.mark.parametrize("n", RANKS[1:])
def test_fused_sharded_epoch_matches_the_step_loop(step_ranks, n):
    """(g) The sharded step's fused epoch (the CPU route: the plain
    rank-order sum, the arithmetic of the card's kernel) against the
    per-step gloo loop on the same draws: one step's losses and EMA
    within 1e-5, three steps' parameters within 2 N lr, the server's
    replicas bit for bit; the 57 all-reduces of the GAN step go through
    the route (one gather each), none through gloo's all_reduce."""
    _, ranks = step_ranks
    recs = _on(ranks, ("fused", n))
    assert len(recs) == n
    for r in recs:
        assert r["sharded"] and r["route"] == {"data": "plain"}
        assert r["loss_diff"] <= STEP_TOL and r["ema_diff"] <= STEP_TOL
        assert r["param_diff"] <= 2 * 3 * LR
        loop, graph = r["calls"]
        assert loop == {"all_reduce": 57} and graph == {"all_gather": 57}
        assert r["messages"] == 3 * 57
    assert len({r["server"] for r in recs}) == 1


@pytest.mark.parametrize("n", RANKS[1:])
def test_plain_shared_all_reduce_is_the_rank_order_sum(step_ranks, n):
    """The shared all-reduce's plain version (and the wrapper on CPU
    tensors) equals the rank-order float32 numpy sum bit for bit on
    every rank, and gloo's all_reduce within 1e-6 of the summed
    magnitudes."""
    _, ranks = step_ranks
    recs = _on(ranks, ("plain", n))
    assert len(recs) == n
    for r in recs:
        assert r.pop("release")
        for size, x in r.items():
            assert x["bits"], size
            assert x["gloo"] <= 1e-6, (size, x["gloo"])


@pytest.mark.parametrize("n", RANKS)
def test_collectives(step_ranks, n):
    """The step's collectives: block order of ``all_gather_rows``,
    ``keep_rows`` its inverse, ``reduce_sum``'s backward a sum over the
    ranks, ``all_reduce_flat`` in place; on 1 rank each is a no-op and
    issues nothing."""
    _, ranks = step_ranks
    recs = _on(ranks, ("coll", n))
    assert len(recs) == n
    for rank, r in enumerate(recs):
        if n == 1:
            assert r["same"] and r["calls"] == {}
            assert r["summed"] == [[1.0] * 3] * 2 and r["grad"] == r["summed"]
            continue
        assert r["gathered"][0] == [[float(10 * q + j), float(10 * q + j + 1)]
                                    for q in range(n) for j in (0, 2, 4)]
        assert r["gathered"][1] == [float(q) for q in range(n) for _ in (0, 1)]
        assert r["kept"] == [[[float(10 * rank + j), float(10 * rank + j + 1)]
                              for j in (0, 2, 4)], [float(rank)] * 2]
        total = float(sum(range(1, n + 1)))
        assert r["summed"] == [[total] * 3] * 2
        assert r["grad"] == [[float(rank + 1) * n] * 3] * 2
        assert r["flat"] == [[float(sum(range(n)))] * 2, [float(n)]]
        # one gather per dtype, one reduce per call
        assert r["calls"] == {"all_gather": 2, "all_reduce": 3}


@pytest.mark.parametrize("shape", [(1, 12, 7, 7, 5), (1, 6, 4, 3)])
def test_batchnorm_reduce_over_one_rank_is_the_local_statistics(shape):
    """The statistics' reducer in ``batchnorm_apply``: summed over one
    rank (the identity) it gives the local mean and variance, outputs
    and running statistics within float32 rounding; its gradient flows
    through the reduced sums."""
    from repro_torch.models import nn as tnn
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = torch.tensor(rng.normal(2.0, 3.0, shape), dtype=torch.float32,
                     requires_grad=True)
    p = {"scale": torch.tensor(rng.normal(size=(1, C)), dtype=torch.float32),
         "bias": torch.tensor(rng.normal(size=(1, C)), dtype=torch.float32),
         "mean": torch.zeros(1, C), "var": torch.ones(1, C)}
    y0, s0 = tnn.batchnorm_apply(p, x, train=True)
    y1, s1 = tnn.batchnorm_apply(p, x, train=True, reduce=lambda t: t)
    g0, = torch.autograd.grad(y0.square().sum(), [x])
    g1, = torch.autograd.grad(y1.square().sum(), [x])
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-5)
    torch.testing.assert_close(g1, g0, rtol=0, atol=1e-4)
    for k in ("mean", "var"):
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", RANKS)
def test_float64_reduce_sum_is_the_rank_order_sum(step_ranks, n):
    """``reduce_sum`` of a float64 tensor (the server's BatchNorm
    statistics): the same sum on every rank, the float64 sum of the
    ranks' terms in rank order within float64's rounding of 48-bit
    words, through one float32 all-reduce each way; its backward the
    ranks' gradients summed alike; on 1 rank the tensor itself."""
    _, ranks = step_ranks
    recs = _on(ranks, ("sum64", n))
    assert len(recs) == n
    want = _terms64(0).numpy()
    for q in range(1, n):
        want = want + _terms64(q).numpy()
    for r in recs:
        assert r["summed"] == recs[0]["summed"]
        np.testing.assert_allclose(r["summed"], want, rtol=2.0 ** -46, atol=0)
        assert r["grad"] == [float(n * k) for k in (1, 2, 3)]
        assert r["calls"] == ({} if n == 1 else {"all_reduce": 2})


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("shape", [(1, 12, 7, 7, 5), (1, 6, 4, 3),
                                   (1, 12, 3)])
def test_server_statistics_do_not_depend_on_the_rank_split(shape, n):
    """A shared server layer's BatchNorm (``batchnorm_apply`` with a
    ``reduce``): ranks that hold blocks of the rows, their float64 sums
    added in rank order (threads stand in for the ranks), normalise
    every row bit for bit as one rank that holds them all
    (``nn.one_rank``) and keep the same running statistics."""
    import threading
    from repro_torch.models import nn as tnn
    rng = np.random.default_rng(1)
    C = shape[-1]
    x = torch.tensor(rng.normal(2.0, 3.0, shape), dtype=torch.float32)
    p = {"scale": torch.tensor(rng.normal(size=(1, C)), dtype=torch.float32),
         "bias": torch.tensor(rng.normal(size=(1, C)), dtype=torch.float32),
         "mean": torch.zeros(1, C), "var": torch.ones(1, C)}
    whole, stats = tnn.batchnorm_apply(p, x, train=True, reduce=tnn.one_rank)
    barrier, slots, outs = threading.Barrier(n), [None] * n, [None] * n

    def rank_body(rank, rows):
        def reduce(t):
            slots[rank] = t
            barrier.wait()
            total = slots[0]
            for part in slots[1:]:
                total = total + part
            barrier.wait()
            return total
        outs[rank] = tnn.batchnorm_apply(p, rows, train=True, reduce=reduce)

    threads = [threading.Thread(target=rank_body, args=(r, rows))
               for r, rows in enumerate(torch.tensor_split(x, n, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert torch.equal(torch.cat([y for y, _ in outs], 1), whole)
    for _, s in outs:
        for k in ("mean", "var"):
            assert torch.equal(s[k], stats[k])


def test_launcher_trains_the_sharded_step(capfd):
    """``--device cpu --fed-devices 2`` with 14 clients on the paper's 7
    devices (7 groups of 2, which 2 ranks divide) trains the sharded
    step: rank 0 prints ``step=sharded`` and says so in its summary."""
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", "huscf-gan", "--device", "cpu",
                       "--fed-devices", "2", "--clients", "14",
                       "--base-size", "8", "--batch", "2", "--epochs", "1",
                       "--federate-every", "1"])
    printed = capfd.readouterr()
    assert "mesh=2dev, step=sharded" in printed.out
    assert out["fed_ranks"] == 2 and out["step_sharded"]
    assert out["groups"] == 7 and out["rounds"] == ["fedavg"]
