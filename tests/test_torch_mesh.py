"""Client-sharded rounds of the port on gloo ranks on the CPU, against the
port's unsharded rounds and the JAX package's.

The reference's tests build meshes of 1-8 forced CPU devices in one
process; the port's counterpart is ranks spawned by
``launch.mesh.run_ranks``, one process group per check, meshes of 1, 2,
4 and 8 ranks carved out of it by ``make_federation_mesh``. The parent
(this pytest process) computes the reference's unsharded rounds with
JAX and hands the numpy results to the ranks, which import no JAX; every
rank runs the port's rounds and returns its largest differences, which
the parent holds to the tolerances.

Tolerances: a sharded round sums each rank's partial ``A @ theta`` in
another order than one product, so it agrees with the unsharded round
and with the reference within 1e-6 (the reference's own sharded tests'
bound); the chunk stream re-associates its sums over the chunks, 1e-5
(as ``tests/test_federation_chunked.py``). A 1-rank mesh and the
fallbacks (rows that do not divide by the mesh) take the single-device
path and are equal bit for bit. Sharded serving splits a cohort's rows
across ranks; eval-mode BatchNorm works per element, and each rank's
rows come back through an all-reduce of zero-filled buffers (adding
zeros is exact), but a convolution's per-row arithmetic on the CPU
depends on the batch it runs in (oneDNN picks its blocking by batch
size), so sharded images agree with unsharded ones within SERVE_TOL =
1e-6 (a few float32 ulps of the tanh range), and a cohort that falls
back is equal bit for bit.

The ranks import this module, which imports no JAX at the top: the
reference is imported inside the tests only.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import federation as tfed  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

N_LAYERS = {"G": 5, "D": 5}
HET_CUTS = ((1, 3, 1, 3), (2, 4, 2, 4), (1, 4, 2, 3), (2, 3, 1, 4))
N_CLUSTERS = 3
SHARD_TOL = 1e-6
CHUNK_TOL = 1e-5
SERVE_TOL = 1e-6


def _groups(lat, spl, n_clients):
    """4 profile groups with distinct owned-layer sets."""
    devices = [lat.PAPER_DEVICES[i % 4] for i in range(n_clients)]
    cuts = [lat.Cut(*HET_CUTS[i % 4]) for i in range(n_clients)]
    return spl.group_by_profile(devices, cuts)


def _inputs(n_clients, seed):
    """Client params (small leaves per owned layer, both nets), weights,
    labels, a cohort and dataset sizes, from numpy."""
    from repro_torch.core import latency as tlat
    from repro_torch.core import splitting as tspl
    rng = np.random.default_rng(seed)
    params = {}
    for g in _groups(tlat, tspl, n_clients):
        for net, pair in (("G", (g.cut.g_h, g.cut.g_t)),
                          ("D", (g.cut.d_h, g.cut.d_t))):
            for l in tspl.client_owned_layers(pair, 5):
                params.setdefault(g.name, {}).setdefault(net, {})[str(l)] = {
                    "w": rng.normal(size=(g.size, 3 + l, 5)).astype(
                        np.float32),
                    "b": rng.normal(size=(g.size, 4)).astype(np.float32)}
    weights = rng.random(n_clients)
    labels = np.arange(n_clients) % N_CLUSTERS
    cohort = np.zeros(n_clients, bool)
    cohort[rng.permutation(n_clients)[:n_clients // 2 + 1]] = True
    sizes = rng.integers(10, 100, n_clients)
    return params, weights, labels, cohort, sizes


def _rounds(fed, fed_dev, fedavg, params, weights, labels, cohort, sizes,
            **kw):
    """The matrix of rounds, through one package's entry points: dense
    host weights, device weights, a cohort round of each, FedAvg, and
    (at 16 clients, 4 per group) the chunk stream (c = 2) with and
    without a cohort."""
    w_c = weights * cohort
    out = {
        "dense": fed(params, weights, labels, **kw),
        "device": fed_dev(params, weights, labels, None, **kw),
        "cohort": fed(params, w_c, labels, cohort_mask=cohort, **kw),
        "device_cohort": fed_dev(params, w_c, labels, cohort, **kw),
        "fedavg": fedavg(params, sizes, **kw)}
    if len(weights) == 16:
        out["chunked"] = fed(params, weights, labels, chunk_size=2, **kw)
        out["chunked_cohort"] = fed(params, w_c, labels, chunk_size=2,
                                    cohort_mask=cohort, **kw)
    return out


def _reference_rounds(n_clients, seed):
    import jax.numpy as jnp
    from repro.core import federation as jfed
    from repro.core import latency as jlat
    from repro.core import splitting as jspl
    params, weights, labels, cohort, sizes = _inputs(n_clients, seed)
    gj = _groups(jlat, jspl, n_clients)

    def fed(p, w, lab, **kw):
        return jfed.federate_client_params(gj, p, w, lab, n_layers=N_LAYERS,
                                           **kw)

    def fed_dev(p, w, lab, mask):
        return jfed.federate_client_params_device(
            gj, p, jnp.asarray(w, jnp.float32), jnp.asarray(lab, jnp.int32),
            N_CLUSTERS, n_layers=N_LAYERS,
            cohort_mask=None if mask is None else jnp.asarray(mask),
            cohort_size=None if mask is None else int(mask.sum()))

    def fedavg(p, s):
        return jfed.fedavg_uniform(gj, p, s, n_layers=N_LAYERS)

    out = _rounds(fed, fed_dev, fedavg, params, weights, labels, cohort,
                  sizes)
    return {k: _numpy_tree(v) for k, v in out.items()}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port_rounds(gt, params_t, weights, labels, cohort, sizes, mesh):
    def fed(p, w, lab, **kw):
        return tfed.federate_client_params(gt, p, w, lab, n_layers=N_LAYERS,
                                           use_kernel=True, **kw)

    def fed_dev(p, w, lab, mask, **kw):
        return tfed.federate_client_params_device(
            gt, p, torch.as_tensor(w, dtype=torch.float32),
            torch.as_tensor(lab), N_CLUSTERS, n_layers=N_LAYERS,
            use_kernel=True,
            cohort_mask=None if mask is None else torch.as_tensor(mask),
            cohort_size=None if mask is None else int(mask.sum()), **kw)

    def fedavg(p, s, **kw):
        return tfed.fedavg_uniform(gt, p, s, n_layers=N_LAYERS,
                                   use_kernel=True, **kw)

    return _rounds(fed, fed_dev, fedavg, params_t, weights, labels, cohort,
                   sizes, mesh=mesh)


def _max_diff(a, b) -> float:
    """Largest |a - b| over two trees of one structure (numpy leaves)."""
    la, lb = list(tree_items(a)), list(tree_items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    return max(float(np.abs(np.asarray(x, np.float64) -
                            np.asarray(y, np.float64)).max())
               for (_, x), (_, y) in zip(la, lb))


def _equal(a, b) -> bool:
    return all(np.array_equal(x, y) and x.dtype == y.dtype
               for (_, x), (_, y) in zip(tree_items(a), tree_items(b)))


# ---------------------------------------------------------------------------
# rank bodies (run in spawned ranks; no JAX)
# ---------------------------------------------------------------------------

def _rank_federation(ref16, ref10):
    """On an 8-rank group: the matrix of rounds on meshes of 1, 2, 4, 8
    ranks at 16 clients, the fallback at 10, the plan cache and the row
    blocks. Returns {check: value} for the parent to assert on."""
    import torch.distributed as dist
    from repro_torch.core import latency as tlat
    from repro_torch.core import splitting as tspl
    rank = dist.get_rank()
    out = {}
    for n_clients, ref, seed in ((16, ref16, 0), (10, ref10, 3)):
        params, weights, labels, cohort, sizes = _inputs(n_clients, seed)
        gt = _groups(tlat, tspl, n_clients)
        pt = state_from_numpy(params, "cpu")
        single = {k: state_to_numpy(v) for k, v in _port_rounds(
            gt, pt, weights, labels, cohort, sizes, None).items()}
        for name, tree in single.items():
            out[(n_clients, 0, name, "single_vs_ref")] = _max_diff(
                tree, ref[name])
        tmpl = {g.name: pt[g.name]["G"] for g in gt}
        for n in (1, 2, 4, 8):
            mesh = tmesh.make_federation_mesh(n, "cpu")
            if not tmesh.in_mesh(mesh):
                continue
            got = {k: state_to_numpy(v) for k, v in _port_rounds(
                gt, pt, weights, labels, cohort, sizes, mesh).items()}
            cache = {}
            plan = tfed.get_federation_plan(gt, "G", 5, tmpl, cache,
                                            mesh=mesh)
            chunked = tfed.get_federation_plan(gt, "G", 5, tmpl, cache,
                                               mesh=mesh, chunk_size=2)
            out[(n_clients, n, "client_axes")] = plan._client_axes
            out[(n_clients, n, "chunk_axes")] = chunked._chunk_axes
            for name, tree in got.items():
                out[(n_clients, n, name, "vs_single")] = _max_diff(
                    tree, single[name])
                out[(n_clients, n, name, "equal_single")] = _equal(
                    tree, single[name])
                out[(n_clients, n, name, "vs_ref")] = _max_diff(tree,
                                                                ref[name])
            if n_clients == 16:
                # a row block keeps K1's 16-byte rows; the dense buffer
                # per rank is 1/n of the whole
                lo, hi = plan.row_block()
                block = plan.flatten(tmpl, torch.device("cpu"), (lo, hi))
                whole = plan.flatten(tmpl, torch.device("cpu"))
                out[(16, n, "block")] = (
                    (lo, hi), block.stride(0) % 32 == 0,
                    block.data_ptr() % 16 == 0,
                    torch.equal(block, whole[lo:hi]),
                    plan.dense_buffer_bytes() * n
                    == tfed.get_federation_plan(
                        gt, "G", 5, tmpl, {}).dense_buffer_bytes())
    # the plan cache keys on the mesh (its ranks), chunk and cohort size
    params, *_ = _inputs(16, 0)
    gt = _groups(tlat, tspl, 16)
    tmpl = {g.name: state_from_numpy(params, "cpu")[g.name]["G"] for g in gt}
    m2, m4 = (tmesh.make_federation_mesh(n, "cpu") for n in (2, 4))
    if tmesh.in_mesh(m4):
        cache = {}
        plans = [tfed.get_federation_plan(gt, "G", 5, tmpl, cache, **kw)
                 for kw in ({}, {"mesh": m2}, {"mesh": m4})]
        again = tfed.get_federation_plan(gt, "G", 5, tmpl, cache, mesh=m2)
        p2c = tfed.get_federation_plan(gt, "G", 5, tmpl, cache, mesh=m2,
                                       chunk_size=2)
        p2cs = tfed.get_federation_plan(gt, "G", 5, tmpl, cache, mesh=m2,
                                        chunk_size=2, cohort_size=8)
        out["cache"] = (len({id(p) for p in plans}), len(cache),
                        again is plans[1], p2c is not plans[1],
                        p2cs is not p2c, p2c._chunk_axes)
    else:
        out["cache"] = None
    # a rebuilt mesh over the same ranks hits the cached plan (every rank
    # builds it: a mesh is a collective)
    m2b = tmesh.make_federation_mesh(2, "cpu")
    if tmesh.in_mesh(m2b):
        cache = {}
        first = tfed.get_federation_plan(gt, "G", 5, tmpl, cache, mesh=m2)
        out["rebuilt"] = (tfed.get_federation_plan(
            gt, "G", 5, tmpl, cache, mesh=m2b) is first, len(cache))
    out["rank"] = rank
    return out


def _state_digest(tr) -> str:
    from repro_torch.core.huscf import _carry_items
    h = hashlib.sha256()
    for path, x in _carry_items(tr.state):
        h.update("/".join(path).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    h.update(tr._mid_ema.cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_trainer_and_serving():
    """On 4 ranks: a trainer with a 4-rank mesh against its unsharded twin
    through a FedAvg and a clustered round; sharded GAN serving against
    unsharded."""
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.core.latency import Cut, PAPER_DEVICES
    from repro_torch.data.partition import build_scenario
    from repro_torch.launch import serve_split as tss
    from repro_torch.models.gan import Z_DIM
    mesh = tmesh.make_federation_mesh(4, "cpu")
    clients = build_scenario("2dom_iid", num_clients=8, base_size=24, seed=0)
    devices = [PAPER_DEVICES[i % 3] for i in range(8)]
    cuts = [Cut(1, 3, 1, 3) if i % 2 == 0 else Cut(2, 4, 2, 4)
            for i in range(8)]
    cfg = HuSCFConfig(batch=4, steps_per_epoch=1, federate_every=1,
                      warmup_fed_rounds=1, seed=0)

    def make(m):
        tr = HuSCFTrainer(clients, devices, cuts=cuts, config=cfg,
                          device="cpu", fed_mesh=m)
        tr.train_steps(1)
        return tr

    tr_mesh, tr_none = make(mesh), make(None)
    out = {"modes": [], "diff": [], "axes": None}
    for kld in (False, False, True):
        d_mesh = tr_mesh.federate(use_label_kld=kld)
        d_none = tr_none.federate(use_label_kld=kld)
        out["modes"].append((d_mesh["mode"], d_none["mode"]))
        out["diff"].append(max(
            _max_diff(state_to_numpy(tr_mesh.state[net]["client"]),
                      state_to_numpy(tr_none.state[net]["client"]))
            for net in ("G", "D")))
    out["axes"] = [p._client_axes for p in tr_mesh._fed_plans.values()]
    out["digest"] = _state_digest(tr_mesh)

    groups = tss.build_mix("balanced")
    client, server = tss.init_gan_serving_state(
        torch.Generator().manual_seed(0), groups, device="cpu")
    sharded = tss.SplitGanEngine(groups, client, server, mesh=mesh)
    single = tss.SplitGanEngine(groups, client, server)
    rng = np.random.default_rng(0)

    def cohort(counts):
        reqs = []
        for g, n in zip(groups, counts):
            for j in range(n):
                reqs.append(tss.ServeRequest(
                    g.client_ids[j % g.size],
                    rng.normal(size=Z_DIM).astype(np.float32),
                    int(rng.integers(0, 10))))
        return reqs

    out["serve"] = []
    for counts in ((3, 7, 13, 0), (4, 8, 16, 2), (1, 1, 0, 0)):
        reqs = cohort(counts)
        _, buckets, _ = sharded.plan(reqs)
        got, want = sharded.serve(reqs), single.serve(reqs)
        out["serve"].append((buckets, sharded.shard_axes(buckets),
                             got.shape, bool(np.array_equal(got, want)),
                             float(np.abs(got - want).max())))
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def federation_ranks():
    ref16, ref10 = _reference_rounds(16, 0), _reference_rounds(10, 3)
    return tmesh.run_ranks(8, _rank_federation, ref16, ref10,
                           device_type="cpu")


ROUNDS = ("dense", "device", "cohort", "device_cohort", "fedavg", "chunked",
          "chunked_cohort")


@pytest.mark.parametrize("n_ranks", [1, 2, 4, 8])
def test_sharded_rounds_match_unsharded_and_reference(federation_ranks,
                                                      n_ranks):
    """16 clients in 4 groups of 4 on meshes of 1-8 ranks: every rank's
    dense, device-weight, cohort and FedAvg rounds (plain K1 path) within
    1e-6 of the port's unsharded round and of the reference, the chunk
    stream within 1e-5; rows shard from 2 ranks up, the chunk stream on 2
    and 4 (every group of 4 divides) and falls back on 8; a 1-rank mesh
    and every fallback is the unsharded round bit for bit."""
    ranks = [r for r in federation_ranks if (16, n_ranks, "dense",
                                             "vs_single") in r]
    assert len(ranks) == n_ranks
    for r in ranks:
        assert r[(16, n_ranks, "client_axes")] == (
            None if n_ranks == 1 else "data")
        assert r[(16, n_ranks, "chunk_axes")] == (
            "data" if n_ranks in (2, 4) else None)
        for name in ROUNDS:
            tol = CHUNK_TOL if name.startswith("chunked") else SHARD_TOL
            assert r[(16, 0, name, "single_vs_ref")] <= tol, name
            assert r[(16, n_ranks, name, "vs_single")] <= tol, name
            assert r[(16, n_ranks, name, "vs_ref")] <= tol, name
            if n_ranks == 1 or (n_ranks == 8 and name.startswith("chunk")):
                assert r[(16, n_ranks, name, "equal_single")], name
        span, strided, aligned, same, one_nth = r[(16, n_ranks, "block")]
        assert span[1] - span[0] == 16 // n_ranks
        assert strided and aligned and same and one_nth


@pytest.mark.parametrize("n_ranks", [2, 4, 8])
def test_non_divisible_rows_fall_back(federation_ranks, n_ranks):
    """10 clients: a 2-rank mesh shards them (within 1e-6); 4 and 8 ranks
    do not divide 10, so the plan takes the unsharded path, bit for bit."""
    ranks = [r for r in federation_ranks if (10, n_ranks, "dense",
                                             "vs_single") in r]
    assert len(ranks) == n_ranks
    for r in ranks:
        axes = r[(10, n_ranks, "client_axes")]
        assert axes == ("data" if n_ranks == 2 else None)
        for name in ROUNDS[:5]:
            assert r[(10, n_ranks, name, "vs_ref")] <= SHARD_TOL, name
            if axes is None:
                assert r[(10, n_ranks, name, "equal_single")], name
            else:
                assert r[(10, n_ranks, name, "vs_single")] <= SHARD_TOL


def test_plan_cache_keys_on_mesh_chunk_and_cohort(federation_ranks):
    """None, 2 ranks and 4 ranks get three plans; the same mesh hits its
    plan; chunk size and cohort size key separately; a mesh rebuilt over
    the same ranks hits the cached plan."""
    for r in federation_ranks:
        if r["rank"] < 4:
            n_plans, n_cache, hit, chunk_new, cohort_new, axes = r["cache"]
            assert (n_plans, hit, chunk_new, cohort_new, axes) == (
                3, True, True, True, "data")
            assert n_cache == 5
        if r["rank"] < 2:
            assert r["rebuilt"] == (True, 1)


@pytest.fixture(scope="module")
def trainer_ranks():
    return tmesh.run_ranks(4, _rank_trainer_and_serving, device_type="cpu")


def test_trainer_sharded_rounds(trainer_ranks):
    """8 clients on 4 ranks: a FedAvg, a clustered round and a host
    label-KLD round within 1e-6 of the unsharded twin; every rank ends
    with the same state, bit for bit."""
    for r in trainer_ranks:
        assert r["modes"] == [("fedavg", "fedavg"),
                              ("clustered", "clustered"),
                              ("clustered", "clustered")]
        assert max(r["diff"]) <= SHARD_TOL, r["diff"]
        assert r["axes"] and all(a == "data" for a in r["axes"])
    assert len({r["digest"] for r in trainer_ranks}) == 1


def test_sharded_serving_equals_unsharded(trainer_ranks):
    """Buckets 4/8/16 shard over 4 ranks, within SERVE_TOL of
    ``mesh=None``; a cohort with a bucket of 2 (or 1) does not divide and
    runs unsharded, equal bit for bit."""
    for r in trainer_ranks:
        shard, small, tiny = r["serve"]
        assert shard[0] == (4, 8, 16) and shard[1] == "data"
        assert shard[2] == (23, 28, 28, 1) and shard[4] <= SERVE_TOL
        assert small[0] == (4, 8, 16, 2) and small[1] is None and small[3]
        assert tiny[1] is None and tiny[3]


def test_launcher_fed_devices_runs_ranks(capfd):
    """``--device cpu --fed-devices 2`` spawns two gloo ranks: rank 0
    prints ``mesh=2dev`` and hands back its summary."""
    from repro_torch.launch import train as ttrain
    out = ttrain.main(["--arch", "huscf-gan", "--device", "cpu",
                       "--fed-devices", "2", "--clients", "4",
                       "--base-size", "12", "--batch", "4", "--epochs", "2",
                       "--federate-every", "1"])
    printed = capfd.readouterr()
    assert "mesh=2dev" in printed.out
    assert printed.out.count("[train] epoch") == 2
    assert "2 ranks on cpu: gloo" in printed.err
    assert out["fed_ranks"] == 2 and out["rounds"] == ["fedavg", "fedavg"]


def _rank_raises():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        tmesh.run_ranks(2, _rank_raises, device_type="cpu", timeout=120)


PRODUCTION_PROBE = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import mesh as M
from repro_torch.sharding import policy as P
multi = sys.argv[1] == "1"
n = 512 if multi else 256
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
m = M.make_production_mesh(multi_pod=multi, device_type="cpu")
print(json.dumps({"names": list(m.mesh_dim_names), "shape": list(m.shape),
                  "sizes": P.axis_sizes(m), "data": list(P.data_axes(m)),
                  "rows": str(P.client_axes(m, 1024))}))
"""


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_group(multi_pod):
    """The production meshes over a fake process group of 256 and 512
    ranks (what the dry runs will use): their axes, and the policy
    reading them as it reads the stand-ins."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    run = subprocess.run([sys.executable, "-c", PRODUCTION_PROBE,
                          str(int(multi_pod))], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(run.stdout.strip().splitlines()[-1])
    shape, names = tmesh.PRODUCTION_SHAPES[multi_pod]
    assert got["names"] == list(names) and got["shape"] == list(shape)
    assert got["sizes"] == dict(zip(names, shape))
    assert got["data"] == (["pod", "data"] if multi_pod else ["data"])
    assert got["rows"] == (str(("pod", "data")) if multi_pod else "data")


def test_mesh_arguments_are_checked():
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmesh.check_mesh(object())
    with pytest.raises(ValueError, match="requested 3 ranks.*has 1"):
        tmesh.make_federation_mesh(3, "cpu")
    with pytest.raises(ValueError, match="needs 256 ranks.*has 1"):
        tmesh.make_production_mesh()
    assert tmesh.pick_backend(4, "cpu")[0] == "gloo"
