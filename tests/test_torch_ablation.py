"""The ablation and KLD-comparison twins (``repro_torch.launch.ablation``)
against the reference's ``benchmarks/ablation_components.py`` (paper
Table 23) and ``benchmarks/kld_comparison.py`` (Table 17).

One clustered federation round of each variant (``warmup_fed_rounds=0``)
from one carried state: a trained state and an EMA of two clusters go
to both packages (``bridge``), and the port is fed the reference's
k-means++ draws (``test_torch_fed.reference_centres``). Labels and k
are equal; weights agree to 1e-3 relative, as in ``tests/test_torch_slice.py``
(beta = 150 multiplies the float32 KLD noise). The runners take the
reference's scenarios, variants and sizes, and the CLI prints one line
per (table, variant, domain).
"""
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from benchmarks import ablation_components as jabl  # noqa: E402
from benchmarks import kld_comparison as jkld  # noqa: E402
from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.launch import ablation as tabl  # noqa: E402

from test_torch_fed import reference_centres  # noqa: E402
from test_torch_fused_epoch import reference_trainer  # noqa: E402

VARIANTS = {"no_cluster": (jabl._NoClusterTrainer, tabl.NoClusterTrainer),
            "no_kld": (jabl._NoKLDTrainer, tabl.NoKLDTrainer),
            "label_kld": (jkld._LabelKLDTrainer, tabl.LabelKLDTrainer)}


def _setup(lat, part):
    clients = part.build_scenario("2dom_highly_noniid", num_clients=4,
                                  base_size=16, seed=0)
    devices = [lat.PAPER_DEVICES[i % 2] for i in range(4)]
    cuts = [lat.Cut(1, 3, 1, 3) if i % 2 == 0 else lat.Cut(2, 4, 2, 4)
            for i in range(4)]
    return clients, devices, cuts


CFG = dict(batch=2, steps_per_epoch=1, federate_every=10 ** 6,
           warmup_fed_rounds=0, seed=0)

@pytest.fixture(scope="module")
def carried():
    """One state (the port's after two steps, in the reference's layout)
    and an EMA of four clients in two clusters of middle activations."""
    clients, devices, cuts = _setup(tlat, tpart)
    tr = thuscf.HuSCFTrainer(clients, devices, cuts=cuts, device="cpu",
                             config=thuscf.HuSCFConfig(**CFG))
    tr.train_steps(2)
    rng = np.random.default_rng(0)
    centres = rng.normal(0, 1, (2, tr._mid_ema.shape[1]))
    ema = centres[np.arange(4) % 2] + 0.4 * rng.normal(
        size=(4, tr._mid_ema.shape[1]))
    return state_to_numpy(tr.state), ema.astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def round_pair(request, carried):
    state, ema = carried
    jcls, tcls = VARIANTS[request.param]
    clients, devices, cuts = _setup(jlat, jpart)
    ref = reference_trainer(jcls, state, clients, devices, cuts=cuts,
                            config=jhuscf.HuSCFConfig(**CFG))
    ref._mid_ema = jax.numpy.asarray(ema)
    ref._ema_init, ref._trained = jax.numpy.asarray(True), True
    _, sub = jax.random.split(ref._cluster_key)
    centres = {k: torch.tensor(c)
               for k, c in reference_centres(ema, sub).items()}
    clients, devices, cuts = _setup(tlat, tpart)
    port = tcls(clients, devices, cuts=cuts,
                config=thuscf.HuSCFConfig(**CFG), device="cpu")
    port.state = state_from_numpy(state, "cpu")
    port._mid_ema, port._ema_init = torch.from_numpy(ema.copy()), True
    return request.param, ref.federate(), port.federate(init_centers=centres)


def test_variant_round_labels_and_k_match_reference(round_pair):
    name, d_ref, d_port = round_pair
    assert d_port["mode"] == "clustered"
    assert int(d_port["k"]) == int(d_ref["k"])
    if name == "no_cluster":
        assert int(d_port["k"]) == 1
    np.testing.assert_array_equal(np.asarray(d_port["labels"]),
                                  np.asarray(d_ref["labels"]))


def test_variant_round_weights_match_reference(round_pair):
    name, d_ref, d_port = round_pair
    got = d_port["weights"]
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(d_ref["weights"]),
                               rtol=1e-3, atol=1e-6)
    if name == "no_kld":
        # beta = 0: within a cluster the weights follow dataset sizes, and
        # the trainer's beta is back after the round
        sizes = np.array([c.n for c in _setup(tlat, tpart)[0]], float)
        lab = np.asarray(d_port["labels"])
        for c in np.unique(lab):
            m = lab == c
            np.testing.assert_allclose(got[m], sizes[m] / sizes[m].sum(),
                                       rtol=1e-6)


@pytest.mark.parametrize("runner,reference,spec", [
    (tabl.run_ablation, jabl.run, tabl.ABLATION),
    (tabl.run_kld_comparison, jkld.run, tabl.KLD_COMPARISON)])
def test_runners_take_the_reference_runs(runner, reference, spec):
    """The reference's scenario, variant names and sizes."""
    got = inspect.signature(runner).parameters
    for name, p in inspect.signature(reference).parameters.items():
        if name != "report":
            assert got[name].default == p.default, name
    src = inspect.getsource(reference)
    scenario, _, variants = spec
    assert f'"{scenario}"' in src
    assert all(f'"{name}"' in src for name, _ in variants)


def test_cli_prints_a_line_per_variant_and_domain(capsys, monkeypatch):
    # the scoring (a CNN trained on generated images) has its own tests
    # in test_torch_quality.py; here each variant trains and is scored
    scored = []

    def score(tr, domains, device):
        scored.append(type(tr).__name__)
        return {d: {k: 0.5 for k in ("accuracy", "f1", "fpr", "score",
                                     "fid")} for d in domains}

    monkeypatch.setattr(tabl, "evaluate_trainer", score)
    out = tabl.main(["--table", "17", "--clients", "3", "--base-size", "24",
                     "--epochs", "1", "--batch", "4", "--device", "cpu"])
    assert scored == ["HuSCFTrainer", "LabelKLDTrainer"]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["name"] for x in lines] == ["table17/activation_kld/gratings",
                                          "table17/label_kld/gratings"]
    assert set(out) == {"table17"}
    assert all(np.isfinite(x[k]) for x in lines
               for k in ("accuracy", "f1", "fpr", "score", "fid"))
