"""The slice end to end: a tiny HuSCF-GAN run on the JAX trainer and on
the port — 3 clients in 2 profile groups, fixed cuts, batch 2, 2 steps
per epoch, one FedAvg warm-up round, then a clustered round.

Both start from the reference's ``_init_state`` draws (carried over with
``repro_torch.bridge``), train on the reference's ``_sample`` batches
(the key chain of its fused epoch), and cluster from the reference's
k-means++ draws (its ``_cluster_key`` chain). Losses, parameters, the
middle-activation EMA and the federation diagnostics must match.

Tolerances: after N Adam steps parameters agree to 2 N lr: Adam's
early steps move each parameter by about lr whatever its gradient's
size, so a tiny gradient whose sign differs between XLA and PyTorch
costs up to 2 lr a step. The first epoch's loss (one Adam step in)
agrees to 1e-4 relative; the second's, three steps and a round in, to
1e-3, as those parameter differences accumulate.
The EMA averages activations of order 1 computed from those
parameters, and takes 1e-3. Cluster labels and k are equal; weights
agree to 1e-3 relative, since beta = 150 multiplies the KLD noise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402

from test_torch_fed import reference_centres  # noqa: E402

LR = 2e-4
STEPS = 2


def _setup(lat, part):
    clients = part.build_scenario("2dom_iid", num_clients=4, base_size=16,
                                  seed=0)[:3]
    devices = [lat.PAPER_DEVICES[0], lat.PAPER_DEVICES[1],
               lat.PAPER_DEVICES[0]]
    cuts = [lat.Cut(1, 3, 1, 3), lat.Cut(2, 4, 2, 4), lat.Cut(1, 3, 1, 3)]
    return clients, devices, cuts


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    cfg = dict(batch=2, steps_per_epoch=STEPS, federate_every=1,
               warmup_fed_rounds=1, seed=0, lr=LR)
    clients, devices, cuts = _setup(jlat, jpart)
    init = jhuscf.HuSCFTrainer._init_state
    with pytest.MonkeyPatch.context() as mp:
        # the reference's own initializer, traced once instead of run op
        # by op (the same draws, several times faster to get on a CPU)
        mp.setattr(jhuscf.HuSCFTrainer, "_init_state",
                   lambda self, k: jax.jit(lambda kk: init(self, kk))(k))
        ref = jhuscf.HuSCFTrainer(clients, devices, cuts=cuts,
                                  config=jhuscf.HuSCFConfig(**cfg))
    key = jax.random.PRNGKey(cfg["seed"] + 1)
    sample = jax.jit(ref._sample)
    batches = []
    for _ in range(2 * STEPS):
        key, ks = jax.random.split(key)
        batches.append(_np(sample(ref._dataset, ks)))
    it = iter(batches)

    def source():
        return {f: {g: torch.tensor(a) for g, a in d.items()}
                for f, d in next(it).items()}

    clients_t, devices_t, cuts_t = _setup(tlat, tpart)
    port = thuscf.HuSCFTrainer(clients_t, devices_t, cuts=cuts_t,
                               config=thuscf.HuSCFConfig(**cfg),
                               device="cpu", batch_source=source)
    port.state = state_from_numpy(_np(ref.state), "cpu")

    snaps = []
    for epoch in range(2):
        m_ref, m_port = ref.train_steps(STEPS), port.train_steps(STEPS)
        ema = (ref.middle_activations(), port.middle_activations())
        centres = None
        if epoch == 1:
            _, sub = jax.random.split(ref._cluster_key)
            centres = {k: torch.tensor(c) for k, c in
                       reference_centres(np.asarray(ref._mid_ema),
                                         sub).items()}
        d_ref = ref.federate()
        d_port = port.federate(init_centers=centres)
        snaps.append({"metrics": (m_ref, m_port), "ema": ema,
                      "diag": (d_ref, d_port),
                      "state": (_np(ref.state), state_to_numpy(port.state))})
    return snaps


def _max_param_diff(want, got):
    worst = 0.0
    for net in ("G", "D"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(want[net])[0]:
            sub = got[net]
            for p in path:
                sub = sub[p.key]
            worst = max(worst, float(np.abs(sub - leaf).max()))
    return worst


@pytest.mark.parametrize("epoch,rtol", [(0, 1e-4), (1, 1e-3)])
def test_losses_match(runs, epoch, rtol):
    m_ref, m_port = runs[epoch]["metrics"]
    for k in ("loss_d", "loss_g"):
        assert abs(m_port[k] - m_ref[k]) <= rtol * abs(m_ref[k]), (k, m_ref,
                                                                   m_port)


@pytest.mark.parametrize("epoch", [0, 1])
def test_middle_activation_ema_matches(runs, epoch):
    e_ref, e_port = runs[epoch]["ema"]
    assert e_port.shape == e_ref.shape == (3, 6272)
    np.testing.assert_allclose(e_port, e_ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("epoch", [0, 1])
def test_params_after_round_match(runs, epoch):
    s_ref, s_port = runs[epoch]["state"]
    assert s_port["step"] == s_ref["step"] == STEPS * (epoch + 1)
    assert _max_param_diff(s_ref, s_port) <= 2 * STEPS * (epoch + 1) * LR


def test_federation_diagnostics_match(runs):
    (d0_ref, d0_port), (d1_ref, d1_port) = (runs[0]["diag"],
                                            runs[1]["diag"])
    assert d0_ref == d0_port == {"round": 1, "mode": "fedavg"}
    assert (d1_port["round"], d1_port["mode"]) == (2, "clustered")
    assert d1_port["k"] == int(d1_ref["k"])
    np.testing.assert_array_equal(d1_port["labels"].numpy(),
                                  np.asarray(d1_ref["labels"]))
    np.testing.assert_allclose(d1_port["weights"].numpy(),
                               np.asarray(d1_ref["weights"]), rtol=1e-3,
                               atol=1e-6)
    assert abs(d1_port["silhouette"] - float(d1_ref["silhouette"])) <= 1e-3
