"""Quality evaluation on the JAX package and on the port: the numpy
metrics, the evaluation CNN, its training, ``evaluate_trainer`` and the
quality launcher.

Tolerances: the numpy metrics are copies and agree to 1e-12. The CNN's
logits and features from the reference's weights agree to 1e-5
relative (float32 convolutions and products summed in another order).
Training runs Adam (b1 = 0.9) for 3 steps from one set of weights on
the same batches; Adam moves a parameter by at most rho_t lr at step t
(see ``test_torch_baselines``), so parameters agree to 2 lr (rho_1 +
rho_2 + rho_3), and the logits of the trained nets to 1e-3 relative.
``evaluate_trainer`` trains three nets for 16 steps each from injected
weights on fixed images: accuracy agrees within one test image (1/300),
F1 and FPR within 2/300, the dataset score to 1e-3 relative and FID to
1e-2 relative (a trace of differences of large matrix square roots).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from benchmarks import quality_scenarios as jquality  # noqa: E402
from repro.metrics import classification as jcls  # noqa: E402
from repro.metrics import scores as jscores  # noqa: E402
from repro.models import classifier as jclf  # noqa: E402
from repro_torch.bridge import (classifier_from_numpy,  # noqa: E402
                                classifier_to_numpy)
from repro_torch.data.synthetic import make_class_balanced  # noqa: E402
from repro_torch.launch import quality as tquality  # noqa: E402
from repro_torch.metrics import classification as tcls  # noqa: E402
from repro_torch.metrics import scores as tscores  # noqa: E402
from repro_torch.models import classifier as tclf  # noqa: E402

from test_torch_baselines import _adam_bound  # noqa: E402


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# numpy metrics
# ---------------------------------------------------------------------------

def _probs(case, rng):
    if case == "random":
        p = rng.uniform(size=(40, 10))
        return p / p.sum(1, keepdims=True)
    if case == "one_hot":
        return np.eye(10)[rng.integers(0, 10, 40)]
    return np.full((40, 10), 0.1)                     # uniform


@pytest.mark.parametrize("case", ["random", "one_hot", "uniform"])
def test_dataset_score_matches(case):
    p = _probs(case, np.random.default_rng(0))
    want = jscores.dataset_score(p)
    assert abs(tscores.dataset_score(p) - want) <= 1e-12 * abs(want)


def _feats(case, rng):
    if case == "random":
        return rng.normal(size=(50, 8)), rng.normal(1, 2, size=(60, 8))
    if case == "zero_variance":                       # constant features
        return np.ones((50, 8)), rng.normal(size=(60, 8))
    a = rng.normal(size=(50, 8))
    return a, a.copy()                                # identical sets


@pytest.mark.parametrize("case", ["random", "zero_variance", "identical"])
def test_fid_matches(case):
    a, b = _feats(case, np.random.default_rng(1))
    want = jscores.fid(a, b)
    assert abs(tscores.fid(a, b) - want) <= 1e-12 * max(1.0, abs(want))
    c = np.cov(a, rowvar=False)
    np.testing.assert_allclose(tscores._sqrtm_psd(c), jscores._sqrtm_psd(c),
                               rtol=0, atol=1e-12)


def _labels(case, rng):
    y = rng.integers(0, 10, 200)
    if case == "random":
        return y, rng.integers(0, 10, 200)
    if case == "absent_class":                        # class 3 never occurs
        y = np.where(y == 3, 4, y)
        return y, np.where(rng.uniform(size=200) < 0.7, y,
                           rng.integers(0, 10, 200))
    return y, y.copy()                                # perfect


@pytest.mark.parametrize("case", ["random", "absent_class", "perfect"])
def test_evaluate_matches(case):
    y, pred = _labels(case, np.random.default_rng(2))
    want, got = jcls.evaluate(y, pred), tcls.evaluate(y, pred)
    for k, v in want.row().items():
        assert abs(got.row()[k] - v) <= 1e-12, (k, got.row(), want.row())
    assert str(got) == str(want)
    for p, n in ((0.3, 100), (0.0, 5), (1.0, 0)):
        assert tcls.wald_ci(p, n) == jcls.wald_ci(p, n)


# ---------------------------------------------------------------------------
# the evaluation CNN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    return _np(jclf.init_cnn(jax.random.PRNGKey(0)))


def test_cnn_apply_matches(ref_params):
    x = np.random.default_rng(3).uniform(-1, 1, (5, 28, 28, 1)
                                          ).astype(np.float32)
    want_l, want_f = jclf.cnn_apply(ref_params, x, return_features=True)
    got_l, got_f = tclf.cnn_apply(classifier_from_numpy(ref_params, "cpu"),
                                  torch.tensor(x), return_features=True)
    for want, got in ((want_l, got_l), (want_f, got_f)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_train_classifier_matches(ref_params, monkeypatch):
    """One epoch of three batches of 128 from the same weights."""
    imgs, labs = make_class_balanced("gratings", 39, seed=0)
    monkeypatch.setattr(jclf, "init_cnn", lambda key, num_classes=10:
                        jax.tree_util.tree_map(jax.numpy.asarray,
                                               ref_params))
    want = _np(jclf.train_classifier(jax.random.PRNGKey(0), imgs, labs,
                                     epochs=1))
    got = tclf.train_classifier(None, imgs, labs, epochs=1,
                                params=classifier_from_numpy(ref_params,
                                                             "cpu"))
    tol = 2 * 1e-3 * _adam_bound(3, b1=0.9)
    back = classifier_to_numpy(got)
    for name, layer in want.items():
        for leaf, a in layer.items():
            assert np.abs(back[name][leaf] - a).max() <= tol, (name, leaf)
    test_i, _ = make_class_balanced("gratings", 3, seed=99)
    want_l = np.asarray(jclf.cnn_apply(want, test_i))
    with torch.no_grad():
        got_l = tclf.cnn_apply(got, torch.tensor(test_i)).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=0,
                               atol=1e-3 * np.abs(want_l).max())


class _StubTrainer:
    """``generate`` returns fixed real images of the asked labels."""

    def __init__(self):
        imgs, labs = make_class_balanced("gratings", 70, seed=1)
        self._by_class = [imgs[labs == c] for c in range(10)]

    def generate(self, n_per_client_batch, labels):
        count = np.zeros(10, int)
        out = []
        for y in labels:
            out.append(self._by_class[y][count[y] % 70])
            count[y] += 1
        return np.stack(out), np.asarray(labels)


def test_evaluate_trainer_matches(monkeypatch):
    """Both packages' ``evaluate_trainer`` on one stub trainer, the
    classifiers' initial weights injected by seed (7 and 8)."""
    inits = {s: _np(jclf.init_cnn(jax.random.PRNGKey(s))) for s in (7, 8)}
    monkeypatch.setattr(
        jclf, "init_cnn", lambda key, num_classes=10: jax.tree_util.tree_map(
            jax.numpy.asarray, inits[int(np.asarray(key)[-1])]))
    monkeypatch.setattr(
        tclf, "init_cnn", lambda gen, num_classes=10, device="cuda":
        classifier_from_numpy(inits[gen.initial_seed()], device))
    want = jquality.evaluate_trainer(_StubTrainer(), ["gratings"])
    got = tquality.evaluate_trainer(_StubTrainer(), ["gratings"],
                                    device="cpu")
    w, g = want["gratings"], got["gratings"]
    n_test = 300
    assert abs(g["accuracy"] - w["accuracy"]) <= 1 / n_test + 1e-12
    for k in ("f1", "fpr"):
        assert abs(g[k] - w[k]) <= 2 / n_test, (k, w, g)
    assert abs(g["score"] - w["score"]) <= 1e-3 * w["score"], (w, g)
    assert abs(g["fid"] - w["fid"]) <= 1e-2 * w["fid"], (w, g)


# ---------------------------------------------------------------------------
# the launcher and devices
# ---------------------------------------------------------------------------

def test_quality_main_prints_one_line_per_domain(capsys):
    res = tquality.main(["--scenario", "2dom_noniid", "--algos",
                         "huscf,fedgan", "--clients", "4", "--base-size",
                         "16", "--epochs", "1", "--batch", "4",
                         "--device", "cpu"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [l["name"] for l in lines] == [
        f"quality/2dom_noniid/{a}/{d}" for a in ("huscf", "fedgan")
        for d in ("gratings", "blobs")]
    for l in lines:
        assert all(np.isfinite(l[k]) for k in ("accuracy", "f1", "fpr",
                                                "score", "fid", "wall_s"))
    from repro_torch.data.partition import build_scenario
    sizes = [c.n for c in build_scenario("2dom_noniid", num_clients=4,
                                         base_size=16, seed=0)]
    for r in res.values():
        assert r["steps"] == max(1, int(np.median(sizes)) // 4)
        assert r["s_per_step"] == r["train_s"] / r["steps"] > 0


def test_quality_entry_points_need_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tclf.init_cnn(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tquality.run_scenario("1dom_iid", num_clients=2, base_size=8,
                              epochs=1, algos=("fedgan",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tquality.evaluate_trainer(_StubTrainer(), ["gratings"])
    assert tclf.init_cnn(torch.Generator().manual_seed(0),
                         device="cpu")["c1"]["w"].device.type == "cpu"
