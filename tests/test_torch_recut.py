"""Online re-cut and population churn of the port's trainer against the
JAX package: the migration of a rebuild (client and server parameters,
EMA rows, Adam, groups, registry) from one state in both packages, and
the behaviour of ``reoptimize_every``, ``apply_churn`` and
``update_profile`` as the reference's ``tests/test_recut.py`` holds it.

Tolerances: a rebuild copies rows (survivors' layers, the server's
copies), which must be equal, and takes float32 means over clients (a
layer newly on the server, a joiner's layer the old server never held,
a joiner's EMA row), which sum in another order and agree to 1e-6
relative to the leaf's scale.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import splitting as jspl  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import genetic as tgen  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MEAN_RTOL = 1e-6
N_LAYERS = {"G": 5, "D": 5}


# ---------------------------------------------------------------------------
# migration parity
# ---------------------------------------------------------------------------

def _old_cuts(lat, n):
    """Two profiles: (2,4,2,4) and (2,3,2,3). The server holds layers 2
    and 3 of each net; every client owns layers 0, 1 and 4."""
    return [lat.Cut(2, 4, 2, 4) if i % 2 == 0 else lat.Cut(2, 3, 2, 3)
            for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    """One reference trainer (6 clients, fixed cuts) holding a seeded
    random state and middle-activation EMA, and its 7th client (the
    joiner of the churn case)."""
    clients = jpart.build_scenario("2dom_noniid", num_clients=8,
                                   base_size=16, seed=0)
    devices = [jlat.PAPER_DEVICES[i % 2] for i in range(6)]
    init = jhuscf.HuSCFTrainer._init_state
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhuscf.HuSCFTrainer, "_init_state",
                   lambda self, k: jax.jit(lambda kk: init(self, kk))(k))
        ref = jhuscf.HuSCFTrainer(clients[:6], devices, _old_cuts(jlat, 6),
                                  config=jhuscf.HuSCFConfig(batch=2, seed=0))
    rng = np.random.default_rng(5)
    state = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) if np.asarray(x).ndim == 0 else
                   rng.normal(size=np.shape(x)).astype(np.float32)),
        ref.state)
    # a trained step counter, and Adam's own step, which a rebuild resets
    state["step"] = np.int32(7)
    for opt in ("opt_g", "opt_d"):
        state[opt] = state[opt]._replace(step=np.int32(7))
    ref.state = jax.tree_util.tree_map(jnp.asarray, state)
    acts = rng.normal(size=(6, 6272)).astype(np.float32)
    ref._mid_ema = jnp.asarray(acts)
    ref._ema_init, ref._trained = jnp.asarray(True), True
    return ref, clients[6]


def _port_from(ref):
    clients = tpart.build_scenario("2dom_noniid", num_clients=8,
                                   base_size=16, seed=0)
    devices = [tlat.PAPER_DEVICES[i % 2] for i in range(6)]
    port = thuscf.HuSCFTrainer(clients[:6], devices, _old_cuts(tlat, 6),
                               config=thuscf.HuSCFConfig(batch=2, seed=0),
                               device="cpu")
    port.state = state_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref.state), "cpu")
    port._mid_ema = torch.from_numpy(np.array(ref._mid_ema))
    port._ema_init = True
    return port, clients[6]


def _close(got, want, exact):
    """Copies equal; means within MEAN_RTOL of the leaf's scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= MEAN_RTOL * scale


def _owned(cut, net):
    h, t = jspl.layer_pair(cut, net)
    return set(jspl.client_owned_layers((h, t), N_LAYERS[net]))


def _check_migration(ref_old_groups, ref, port, old_of):
    """Every leaf of both nets against the reference: a client row is a
    copy when its client owned the layer before or the old server held
    it, else a mean; a server layer is a copy when the old server held
    it, else a mean."""
    old_loc = {cid: g for g in ref_old_groups for cid in g.client_ids}
    old_server = {net: {l for g in ref_old_groups
                        for l in range(*jspl.layer_pair(g.cut, net))}
                  for net in ("G", "D")}
    got = state_to_numpy(port.state)
    want = jax.tree_util.tree_map(np.asarray, ref.state)
    assert [(g.name, g.client_ids) for g in port.groups] == [
        (g.name, g.client_ids) for g in ref.groups]
    n_mean = 0
    for net in ("G", "D"):
        for g in ref.groups:
            c_got, c_want = got[net]["client"][g.name], \
                want[net]["client"][g.name]
            assert sorted(c_got) == sorted(c_want)
            for layer in c_want:
                l = int(layer)
                for pos, cid in enumerate(g.client_ids):
                    o = old_of[cid]
                    exact = ((o >= 0 and l in _owned(old_loc[o].cut, net))
                             or l in old_server[net])
                    n_mean += not exact
                    for a, b in zip(jax.tree_util.tree_leaves(c_got[layer]),
                                    jax.tree_util.tree_leaves(
                                        c_want[layer])):
                        _close(a[pos], b[pos], exact)
        s_got, s_want = got[net]["server"], want[net]["server"]
        assert sorted(s_got) == sorted(s_want)
        for layer in s_want:
            exact = int(layer) in old_server[net]
            n_mean += not exact
            for a, b in zip(jax.tree_util.tree_leaves(s_got[layer]),
                            jax.tree_util.tree_leaves(s_want[layer])):
                _close(a, b, exact)
    # Adam restarts on the migrated structure; the step counter survives
    for opt in ("opt_g", "opt_d"):
        assert int(got[opt].step) == int(want[opt].step) == 0
        for moments in (got[opt].mu, got[opt].nu):
            assert all(not np.any(x) for x in
                       jax.tree_util.tree_leaves(moments))
        assert (jax.tree_util.tree_structure(got[opt].mu)
                == jax.tree_util.tree_structure(want[opt].mu))
    assert port.state["step"] == int(want["step"]) == 7
    np.testing.assert_array_equal(port.registry.sizes, ref.registry.sizes)
    np.testing.assert_array_equal(port.sizes, ref.sizes)
    assert [c.as_tuple() for c in port.cuts] == [c.as_tuple()
                                                  for c in ref.cuts]
    return n_mean


def test_rebuild_recut_matches_reference(reference):
    """An identity-preserving re-cut: profile 0 moves G to (1,4) and D
    to (1,3) (layer 1 newly on the server, D's layer 3 newly on the
    client), profile 1 moves D to (2,4)."""
    ref = copy.copy(reference[0])
    port, _ = _port_from(ref)
    old_groups = list(ref.groups)
    ema = np.array(ref._mid_ema)
    new = {0: (1, 4, 1, 3), 1: (2, 3, 2, 4)}
    old_of = list(range(6))
    ref._rebuild_population(ref.clients, ref.devices,
                            [jlat.Cut(*new[i % 2]) for i in range(6)],
                            old_of)
    port._rebuild_population(port.clients, port.devices,
                             [tlat.Cut(*new[i % 2]) for i in range(6)],
                             old_of)
    assert _check_migration(old_groups, ref, port, old_of) > 0
    np.testing.assert_array_equal(port._mid_ema.numpy(), ema)
    np.testing.assert_array_equal(np.asarray(ref._mid_ema), ema)
    assert port._fed_plans == {}


def test_rebuild_churn_matches_reference(reference):
    """Client 0 leaves and a client on an unseen profile joins under
    cut (1,3,2,4): its layers 0 and 4 (never on the old server) take the
    population mean, G's layer 3 the server's copy; G's layer 1 is newly
    on the server (the mean of the old client copies)."""
    ref = copy.copy(reference[0])
    joiner_j = reference[1]
    port, joiner_t = _port_from(ref)
    old_groups = list(ref.groups)
    ema = np.array(ref._mid_ema)
    fast_j = jlat.DeviceProfile("ultrafast", 3.0e9, 64.0, 500e6)
    fast_t = tlat.DeviceProfile("ultrafast", 3.0e9, 64.0, 500e6)
    _, old_of = ref.registry.churn([0], [joiner_j.n])
    _, old_of_t = port.registry.churn([0], [joiner_t.n])
    assert old_of == old_of_t == [1, 2, 3, 4, 5, -1]
    cuts = [_old_cuts(jlat, 6)[o] for o in old_of[:-1]] + [
        jlat.Cut(1, 3, 2, 4)]
    ref._rebuild_population(ref.clients[1:] + [joiner_j],
                            ref.devices[1:] + [fast_j], cuts, old_of)
    port._rebuild_population(
        port.clients[1:] + [joiner_t], port.devices[1:] + [fast_t],
        [tlat.Cut(*c.as_tuple()) for c in cuts], old_of)
    assert _check_migration(old_groups, ref, port, old_of) > 0
    got, want = port._mid_ema.numpy(), np.asarray(ref._mid_ema)
    np.testing.assert_array_equal(got[:5], ema[1:])
    np.testing.assert_array_equal(want[:5], ema[1:])
    _close(got[5], want[5], exact=False)
    assert port.registry.n_clients == 6
    assert int(port.registry.sizes[-1]) == joiner_t.n
    assert any(g.profile.name == "ultrafast" for g in port.groups)
    assert port._dataset.n_clients == 6


def test_rebuild_checks_the_cohort_after_churn(reference):
    port, _ = _port_from(reference[0])
    port.cfg = thuscf.HuSCFConfig(batch=2, seed=0, cohort_size=6)
    with pytest.raises(ValueError, match="after churn"):
        port.apply_churn(leave=[0])


# ---------------------------------------------------------------------------
# behaviour, as the reference's tests/test_recut.py holds it
# ---------------------------------------------------------------------------

GA = tgen.GAConfig(population_size=48, generations=8, seed=0,
                   early_stop_patience=4)


def mk_clients(n, seed=0, size=64, id0=0):
    rng = np.random.default_rng(seed)
    return [tpart.ClientSpec(id0 + i, "gratings",
                             rng.normal(size=(size, 28, 28, 1)).astype(
                                 np.float32),
                             rng.integers(0, 10, size).astype(np.int64))
            for i in range(n)]


def mk_trainer(n=4, dev_mod=2, ga=GA, **cfg_kw):
    cfg = thuscf.HuSCFConfig(batch=8, federate_every=1, seed=0,
                             steps_per_epoch=1, warmup_fed_rounds=0, **cfg_kw)
    devices = [tlat.PAPER_DEVICES[i % dev_mod] for i in range(n)]
    return thuscf.HuSCFTrainer(mk_clients(n), devices, config=cfg,
                               ga_config=ga, device="cpu")


def client_leaf(trainer, cid, net="G", layer="0"):
    for g in trainer.groups:
        if cid in g.client_ids:
            pos = g.client_ids.index(cid)
            tree = trainer.state[net]["client"][g.name][layer]
            return tree_leaves(tree)[0][pos].clone()
    raise AssertionError(f"client {cid} not found")


def test_reoptimize_every_converges_then_stops_churning():
    """With unchanged profiles the per-round search improves the
    incumbent monotonically and then goes quiet: ties do not regroup
    and do not empty the plan cache. Two profiles keep the gene space
    at 16^2 = 256, so 128 individuals find the optimum at once."""
    tr = mk_trainer(dev_mod=2,
                    ga=tgen.GAConfig(population_size=128, generations=12,
                                     seed=0, early_stop_patience=6),
                    reoptimize_every=1)
    tr.train_steps(1)
    recuts, lats = [], [tr.ga_latency]
    for _ in range(3):
        diag = tr.federate()
        recuts.append(diag["recut"])
        lats.append(tr.ga_latency)
    assert all(b <= a + 1e-12 for a, b in zip(lats, lats[1:]))
    assert recuts[-2:] == [False, False]
    assert len(tr._fed_plans) > 0
    plans = set(tr._fed_plans)
    cuts_tail = [c.as_tuple() for c in tr.cuts]
    diag = tr.federate()
    assert diag["recut"] is False
    assert [c.as_tuple() for c in tr.cuts] == cuts_tail
    assert set(tr._fed_plans) == plans
    assert len(tr._searchers) == 1


def test_churn_recut_migration_and_plan_invalidation():
    """Client 0 leaves and an unseen-profile client joins: the cuts are
    re-derived, the groups rebuilt, the plan cache emptied, survivors
    keep their parameters and EMA rows under compacted ids, the joiner's
    EMA row is the survivor mean, and the trainer trains and federates
    again."""
    tr = mk_trainer(5)
    tr.train_steps(1)
    tr.federate()
    assert len(tr._fed_plans) > 0
    old_ema = tr._mid_ema.clone()
    surv_before = client_leaf(tr, 2)       # old client 2 -> new id 1
    fast = tlat.DeviceProfile("ultrafast", 3.0e9, 64.0, 500e6)
    joiner = mk_clients(1, seed=99, id0=5)[0]
    cuts = tr.apply_churn(leave=[0], join=[(joiner, fast)])
    assert len(tr.clients) == 5 and len(cuts) == 5
    assert any(g.profile.name == "ultrafast" for g in tr.groups)
    assert tr._fed_plans == {}
    assert tr.registry.n_clients == 5
    assert int(tr.registry.sizes[-1]) == joiner.n
    assert torch.equal(client_leaf(tr, 1), surv_before)
    assert torch.equal(tr._mid_ema[:4], old_ema[1:])
    torch.testing.assert_close(tr._mid_ema[-1], old_ema[1:].mean(0),
                               rtol=1e-5, atol=1e-6)
    tr.train_steps(1)
    diag = tr.federate()
    assert diag["mode"] in ("fedavg", "clustered")
    assert len(tr._fed_plans) > 0


def test_update_profile_regroups_and_keeps_identity():
    """A degraded-bandwidth report re-derives the cuts; the client keeps
    its dataset, parameters and EMA row, and the rebuilt trainer trains
    and generates."""
    tr = mk_trainer(3)
    tr.train_steps(1)
    ema_before = tr.middle_activations().copy()
    with pytest.raises(ValueError, match="unknown client id"):
        tr.update_profile(7, tlat.PAPER_DEVICES[0])
    slow = tlat.DeviceProfile("degraded", 0.25e9, 4.0, 1.2e6)
    tr.update_profile(1, slow)
    assert tr.devices[1] is slow
    assert any(g.profile.name == "degraded" for g in tr.groups)
    assert tr._fed_plans == {}
    np.testing.assert_array_equal(tr.middle_activations(), ema_before)
    assert len(tr.clients) == 3
    tr.train_steps(1)
    labels = np.arange(8) % 10
    imgs, labs = tr.generate(2, labels)
    assert imgs.shape == (8, 28, 28, 1) and np.isfinite(imgs).all()
    np.testing.assert_array_equal(labs, labels)


def test_launcher_reoptimize_every_on_cpu(capsys):
    tr = ttrain.main(["--arch", "huscf-gan", "--device", "cpu", "--clients",
                      "4", "--base-size", "24", "--batch", "4", "--epochs",
                      "3", "--federate-every", "1", "--reoptimize-every",
                      "1"])
    out = capsys.readouterr().out
    assert ", re-cut every 1 rounds" in out
    assert tr.cfg.reoptimize_every == 1
    assert [d["recut"] for d in tr.fed_log] == [False, False, False]
