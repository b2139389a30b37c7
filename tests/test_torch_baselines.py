"""The five baselines, their latency models and the helpers they need,
on the JAX package and on the port.

Each baseline runs 3 clients, batch 4, one step per epoch and a
federation every epoch, for two epochs. Both packages start from the
reference's ``init_population`` weights (carried over with
``repro_torch.bridge``) and draw every batch from the same seeded
numpy generator, so they see the same data.

Tolerances: parameters differ by what Adam makes of gradients that
are zero up to rounding (a conv bias before BatchNorm, whose batch mean
cancels it): Adam's early steps move a parameter by about lr whatever
its gradient's size, so such a gradient whose sign differs between XLA
and PyTorch costs up to 2 lr a step. Exactly, step t moves a parameter
by at most rho_t lr, rho_t = sqrt(sum_i a_i^2 / u_i) over the bias-
corrected weights a_i of the first moment and u_i of the second
(rho_1 = 1, rho_2 = 1.054 at b1 = 0.5), so after N steps parameters
agree to 2 lr (rho_1 + ... + rho_N), about the slice test's 2 N lr. The
first epoch's losses (the G loss after one D step) agree to 1e-4
relative; the second epoch's, one step and a federation in, to 1e-3,
as those parameter differences reach the losses. Host logic
(HFL-GAN's groups, MD-GAN's permutation, the latency models, the
bridge) is exact; SGD agrees to 1e-7 and the weighted sum to 1e-6
relative (float32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import baselines as jbase  # noqa: E402
from repro.baselines import hfl_gan as jhfl  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import baselines as tbase  # noqa: E402
from repro_torch.baselines import hfl_gan as thfl  # noqa: E402
from repro_torch.bridge import (classifier_from_numpy,  # noqa: E402
                                classifier_to_numpy, single_from_numpy,
                                single_to_numpy, state_from_numpy,
                                state_to_numpy)
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

LR = 2e-4
EPOCHS = 2
NAMES = sorted(jbase.ALL_BASELINES)
# attributes carried over and compared: (name, has a client axis)
_POPULATION = [("g_params", True), ("d_params", True), ("opt_g", True),
               ("opt_d", True)]
_STATE = {
    "fedgan": _POPULATION, "pfl_gan": _POPULATION, "hfl_gan": _POPULATION,
    "mdgan": _POPULATION + [("g_server", False), ("opt_gs", False)],
    "fed_split_gan": [("g_server", False), ("opt_gs", False),
                      ("d_heads", True), ("opt_dh", True),
                      ("d_tail", False), ("opt_dt", False)],
}


def _adam_bound(steps, b1=0.5, b2=0.999):
    """sum over t <= steps of the largest |m_hat / sqrt(v_hat)| Adam can
    take at step t (the module docstring's rho_t)."""
    total = 0.0
    for t in range(1, steps + 1):
        a = np.array([(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)])
        u = np.array([(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)])
        a, u = a / (1 - b1 ** t), u / (1 - b2 ** t)
        total += float(np.sqrt((a ** 2 / u).sum()))
    return total


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clients(part):
    return part.build_scenario("2dom_iid", num_clients=4, base_size=16,
                               seed=0)[:3]


def _cfg(mod):
    return mod.BaselineConfig(batch=4, steps_per_epoch=1, federate_every=1,
                              seed=0, lr=LR)


def _carry(ref, port, name):
    for attr, stacked in _STATE[name]:
        conv = state_from_numpy if stacked else single_from_numpy
        setattr(port, attr, conv(_np(getattr(ref, attr)), "cpu"))


def _port_np(port, attr, stacked):
    return (state_to_numpy if stacked else single_to_numpy)(
        getattr(port, attr))


def _max_diff(want, got):
    """Largest |difference| over the leaves of two numpy trees (of an
    Adam state: over its moments)."""
    if hasattr(want, "mu"):
        return max(_max_diff(want.mu, got.mu), _max_diff(want.nu, got.nu))
    worst = 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        sub = got
        for p in path:
            sub = sub[p.key]
        worst = max(worst, float(np.abs(np.asarray(sub) - leaf).max()))
    return worst


def _train_both(name):
    """Both packages' trainers of one baseline after two epochs, with
    the losses of each epoch and the groups of every HFL-GAN round."""
    groups = {"ref": [], "port": []}

    def record(side, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            groups[side].append(np.asarray(out[0]))
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhfl, "kmeans", record("ref", jhfl.kmeans))
        mp.setattr(thfl, "kmeans_np", record("port", thfl.kmeans_np))
        ref = jbase.ALL_BASELINES[name](_clients(jpart), _cfg(jbase))
        port = tbase.ALL_BASELINES[name](_clients(tpart), _cfg(tbase),
                                         device="cpu")
        _carry(ref, port, name)
        losses = [(ref.train_epoch(), port.train_epoch())
                  for _ in range(EPOCHS)]
    return {"name": name, "ref": ref, "port": port, "losses": losses,
            "groups": groups}


@pytest.fixture(scope="module")
def trained():
    """Each baseline's run, made once on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _train_both(name)
        return cache[name]
    return get


@pytest.fixture(params=NAMES)
def run(request, trained):
    return trained(request.param)


@pytest.mark.parametrize("epoch,rtol", [(0, 1e-4), (1, 1e-3)])
def test_losses_match(run, epoch, rtol):
    m_ref, m_port = run["losses"][epoch]
    for k in ("loss_d", "loss_g"):
        assert abs(m_port[k] - m_ref[k]) <= rtol * abs(m_ref[k]), (
            run["name"], k, m_ref, m_port)


def test_params_after_federation(run):
    """Every carried parameter tree after two steps and two federations,
    and Adam's step. The moments are not compared: they hold gradients,
    and one activation at the leaky ReLU's kink (|x| ~ 4e-7, a sign that
    float32 rounding decides) changes a client's gradients by percents
    (fed_split_gan, fedgan: found against a float64 run of the port)."""
    tol = 2 * LR * _adam_bound(EPOCHS)
    for attr, stacked in _STATE[run["name"]]:
        want = _np(getattr(run["ref"], attr))
        got = _port_np(run["port"], attr, stacked)
        if hasattr(want, "step"):
            assert int(np.asarray(want.step).reshape(-1)[0]) == got.step
        else:
            assert _max_diff(want, got) <= tol, (run["name"], attr)


def test_generate_shapes_and_labels(run):
    labels = np.arange(10) % 10
    imgs_r, labs_r = run["ref"].generate(4, labels)
    imgs_p, labs_p = run["port"].generate(4, labels)
    assert imgs_p.shape == np.asarray(imgs_r).shape == (10, 28, 28, 1)
    np.testing.assert_array_equal(labs_p, np.asarray(labs_r))
    assert np.isfinite(imgs_p).all() and np.abs(imgs_p).max() <= 1.0


def test_hfl_groups_equal_reference(trained):
    """HFL-GAN's k-means groups, every round: the port flattens its
    generators in the reference's order and layouts."""
    run = trained("hfl_gan")
    assert len(run["groups"]["ref"]) == EPOCHS
    for want, got in zip(run["groups"]["ref"], run["groups"]["port"]):
        np.testing.assert_array_equal(got, want)


def test_hfl_embedding_equals_reference():
    """From one state the projected generator embeddings are equal."""
    ref = jbase.HFLGANTrainer(_clients(jpart), _cfg(jbase))
    port = tbase.HFLGANTrainer(_clients(tpart), _cfg(tbase), device="cpu")
    _carry(ref, port, "hfl_gan")
    emb = ref._flat_g()
    np.testing.assert_array_equal(port._flat_g(), emb)
    np.testing.assert_array_equal(port.group_labels(),
                                  jhfl.kmeans(emb, 2, seed=0)[0])


def test_mdgan_permutation_equals_reference():
    """``federate`` swaps the discriminators and their Adam moments with
    the host generator's permutation: bit for bit from one state."""
    ref = jbase.MDGANTrainer(_clients(jpart), _cfg(jbase))
    port = tbase.MDGANTrainer(_clients(tpart), _cfg(tbase), device="cpu")
    rng = np.random.default_rng(3)
    ref.opt_d = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32))
        if x.ndim > 1 else x, ref.opt_d)
    _carry(ref, port, "mdgan")
    ref.federate()
    port.federate()
    assert _max_diff(_np(ref.d_params), state_to_numpy(port.d_params)) == 0
    assert _max_diff(_np(ref.opt_d), state_to_numpy(port.opt_d)) == 0
    assert (ref._rng.bit_generator.state == port._rng.bit_generator.state)


# ---------------------------------------------------------------------------
# latency models, optimisers, tree helpers, bridge, devices
# ---------------------------------------------------------------------------

def _mix(lat, seed, n):
    rng = np.random.default_rng(seed)
    return [lat.PAPER_DEVICES[i] for i in rng.integers(0, 7, n)]


@pytest.mark.parametrize("fn", ["fedgan_iteration_latency",
                                "hflgan_iteration_latency",
                                "pflgan_iteration_latency",
                                "mdgan_iteration_latency",
                                "fedsplitgan_iteration_latency"])
@pytest.mark.parametrize("seed,n,batch", [(0, 8, 64), (1, 100, 16),
                                          (2, 1, 32)])
def test_baseline_latency_bit_for_bit(fn, seed, n, batch):
    want = getattr(jlat, fn)(_mix(jlat, seed, n), batch=batch)
    got = getattr(tlat, fn)(_mix(tlat, seed, n), batch=batch)
    assert got == want


def _tree(rng):
    return {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "c": rng.normal(size=(2, 2, 3)).astype(np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr", [0.05, lambda s: 0.1 / s],
                         ids=["const", "schedule"])
def test_sgd_matches_reference(momentum, lr):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    j_init, j_upd = jopt.sgd(lr, momentum)
    t_init, t_upd = topt.sgd(lr, momentum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch_tree(params)
    js, ts = j_init(jp), t_init(tp)
    for g in grads:
        js, jp = j_upd(js, jax.tree_util.tree_map(jnp.asarray, g), jp)
        ts, tp = t_upd(ts, _torch_tree(g), tp)
    assert ts.step == int(js.step) == 3
    for path, x in tree_items(tp):
        want = jp
        for k in path:
            want = want[k]
        np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=1e-7,
                                   atol=1e-7)


def test_tree_weighted_sum_matches_reference():
    rng = np.random.default_rng(1)
    stacked = {"x": rng.normal(size=(5, 3, 4)).astype(np.float32),
               "y": {"z": rng.normal(size=(5, 7)).astype(np.float32)}}
    w = rng.uniform(size=5)
    want = jnn.tree_weighted_sum(jax.tree_util.tree_map(jnp.asarray,
                                                        stacked),
                                 jnp.asarray(w / w.sum()))
    got = tnn.tree_weighted_sum(_torch_tree(stacked),
                                torch.tensor(w / w.sum()))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["y"]["z"].numpy(),
                               np.asarray(want["y"]["z"]), rtol=1e-6,
                               atol=1e-7)


def test_bridge_vmapped_adam_step():
    """The reference's per-client Adam has a [K] step: equal entries
    become the port's one int and come back exact; unequal ones raise."""
    ref = jbase.FedGANTrainer(_clients(jpart), _cfg(jbase))
    opt = _np(ref.opt_d)
    assert opt.step.shape == (3,)
    got = state_from_numpy(opt, "cpu")
    assert isinstance(got, AdamState) and got.step == 0
    back = state_to_numpy(got)
    assert _max_diff(opt, back) == 0
    bad = opt._replace(step=np.array([1, 1, 2], np.int32))
    with pytest.raises(ValueError, match="steps differ"):
        state_from_numpy(bad, "cpu")


def test_bridge_single_network_round_trip():
    """MD-GAN's server G: no client axis in the reference, K = 1 here."""
    ref = jbase.MDGANTrainer(_clients(jpart), _cfg(jbase))
    g = _np(ref.g_server)
    got = single_from_numpy(g, "cpu")
    assert got["1"]["convt"]["w"].shape == (1, 256, 128, 4, 4)
    back = single_to_numpy(got)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        sub = back
        for p in path:
            sub = sub[p.key]
        np.testing.assert_array_equal(sub, leaf)


def test_bridge_classifier_round_trip():
    from repro.models import classifier as jclf
    params = _np(jclf.init_cnn(jax.random.PRNGKey(0)))
    got = classifier_from_numpy(params, "cpu")
    assert got["c1"]["w"].shape == (32, 1, 3, 3)
    assert got["c2"]["w"].shape == (64, 32, 3, 3)
    assert got["fc1"]["w"].shape == (7 * 7 * 64, 128)
    back = classifier_to_numpy(got)
    for name, layer in params.items():
        for leaf, a in layer.items():
            np.testing.assert_array_equal(back[name][leaf], a)


@pytest.mark.parametrize("name", NAMES)
def test_baseline_needs_gpu_unless_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbase.ALL_BASELINES[name](_clients(tpart), _cfg(tbase))
    tr = tbase.ALL_BASELINES[name](_clients(tpart), _cfg(tbase),
                                   device="cpu")
    assert tr.device.type == "cpu"
