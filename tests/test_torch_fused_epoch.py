"""The port's fused epoch (``HuSCFConfig.fused_epoch``, the default, and
``core.huscf.make_epoch_fn``) on the CPU, where its steps run eagerly:
the plain version of the CUDA graphs the card replays.

* The fused body against the per-step loop (``fused_epoch=False``), from
  one state and one generator, bit for bit: both run the same step and
  Adam arithmetic (the step count on the device), the fused one writing
  into the trainer's own tensors.
* The EMA's device flag: a first observation copies, later ones blend.
* A state replaced from outside (a federation round, a checkpoint-style
  assignment, a regroup through ``_rebuild_population``) is the state
  the next fused epoch trains.
* ``epoch_unroll`` through a stand-in graph pool, which "captures" the
  steps by keeping the function and "replays" them eagerly: the warm-up
  step, the graph sizes and the remainder graph of the card's path.
* The port's fused epoch against the reference's, fed the reference's
  ``_sample`` batches, from the port's initial state carried across with
  ``bridge``. Tolerances are those of ``tests/test_torch_slice.py``:
  parameters within 2 N lr after N Adam steps, the EMA within 1e-3, the
  first epoch's loss (one Adam step in) 1e-4 relative.
* The launcher prints ``fused epochs`` by default, ``per-step epochs``
  with ``--per-step``.

Tests marked ``cuda`` check the graphs themselves and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim.optimizers import AdamState as JAdam  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.tree import tree_items, tree_map  # noqa: E402

LR = 2e-4
STEPS = 3


def _setup(lat, part, n: int = 3):
    """n clients of ``2dom_iid``: 3 in two profile groups, 2 in one."""
    clients = part.build_scenario("2dom_iid", num_clients=4, base_size=16,
                                  seed=0)[:n]
    devices = [lat.PAPER_DEVICES[0], lat.PAPER_DEVICES[1],
               lat.PAPER_DEVICES[0]][:n] if n == 3 else \
        [lat.PAPER_DEVICES[0]] * n
    cuts = [lat.Cut(1, 3, 1, 3) if d == lat.PAPER_DEVICES[0]
            else lat.Cut(2, 4, 2, 4) for d in devices]
    return clients, devices, cuts


def reference_trainer(cls, state_np, *args, **kw):
    """A reference trainer of class ``cls`` that starts from ``state_np``
    (a port state in the reference's layout, ``state_to_numpy``) instead
    of its own draws, so no initializer is traced."""
    def init(self, key):
        self._opt_init_g, self._opt_update_g = jadam(self.cfg.lr,
                                                     b1=self.cfg.adam_b1)
        self._opt_init_d, self._opt_update_d = jadam(self.cfg.lr,
                                                     b1=self.cfg.adam_b1)
        to_jax = jax.tree_util.Partial(jax.tree_util.tree_map, jnp.asarray)
        return {k: (JAdam(*map(to_jax, v)) if isinstance(v, tuple)
                    else to_jax(v)) for k, v in state_np.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhuscf.HuSCFTrainer, "_init_state", init)
        return cls(*args, **kw)


def _trainer(fused: bool, device="cpu", **cfg):
    clients, devices, cuts = _setup(tlat, tpart)
    return thuscf.HuSCFTrainer(
        clients, devices, cuts=cuts, device=device,
        config=thuscf.HuSCFConfig(batch=2, steps_per_epoch=STEPS,
                                  federate_every=10 ** 6, lr=LR,
                                  fused_epoch=fused, **cfg))


def _leaves(tr):
    return thuscf._carry_items(tr.state)


def _equal_bits(a, b):
    """Equal tensors, or equal Adam steps (an int after a ``bridge``
    assignment on the step loop, a 0-dim tensor once fused)."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return int(a) == int(b)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


class FakeGraph:
    def __init__(self, run):
        self.replay = run


class FakePool:
    """A ``GraphPool`` stand-in: a capture keeps the function, a replay
    calls it, so the card's control flow runs eagerly on the CPU."""

    def __init__(self):
        self.clear()
        self.sizes = []

    def clear(self):
        self.warm = False
        self.captures = []

    def warm_up(self, step):
        step()
        self.warm = True

    def capture(self, run, gen, steps):
        self.captures.append(run)
        return FakeGraph(run)

    def replay(self, graphs):
        self.sizes.append(len(graphs))
        for g in graphs:
            g.replay()


# ---------------------------------------------------------------------------
# fused body against the step loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """(fused, loop) trainers from one seed: two epochs and a FedAvg
    round between them."""
    out = []
    for fused in (True, False):
        tr = _trainer(fused, warmup_fed_rounds=1)
        tr.train_steps(STEPS)
        tr.federate()
        out.append((tr, tr.train_steps(STEPS)))
    return out


def test_fused_body_losses_match_step_loop(pair):
    (_, mf), (_, ml) = pair
    assert mf == ml


@pytest.mark.parametrize("what", ["G", "D", "opt_g", "opt_d"])
def test_fused_body_state_matches_step_loop(pair, what):
    (f, _), (lp, _) = pair
    got = [(p, x) for p, x in _leaves(f) if p[0] == what]
    want = [(p, x) for p, x in _leaves(lp) if p[0] == what]
    assert [p for p, _ in got] == [p for p, _ in want] and got
    assert all(_equal_bits(x, y) for (_, x), (_, y) in zip(got, want))
    assert f.state["step"] == lp.state["step"] == 2 * STEPS


def test_fused_body_ema_and_generator_match_step_loop(pair):
    (f, _), (lp, _) = pair
    assert torch.equal(f._mid_ema, lp._mid_ema)
    assert torch.equal(f._train_gen.get_state(), lp._train_gen.get_state())
    # Adam's step lives on the device, as the fused path needs it
    assert isinstance(f.state["opt_d"].step, torch.Tensor)
    assert int(f.state["opt_d"].step) == int(lp.state["opt_d"].step) == \
        2 * STEPS


def test_fused_epoch_writes_its_own_tensors():
    f = _trainer(True)
    f.train_steps(1)
    before = [x for _, x in _leaves(f)] + [f._mid_ema]
    f.train_steps(1)
    after = [x for _, x in _leaves(f)] + [f._mid_ema]
    assert all(a is b for a, b in zip(before, after))


def test_a_trained_trainer_is_freed_with_its_last_reference():
    """No reference cycle through the epoch functions: the state (and on
    the card the graphs' pool) goes when the trainer does, without
    waiting for the garbage collector."""
    import gc
    import weakref
    tr = _trainer(True)
    tr._graph_pool = FakePool()
    tr.train_steps(2)
    assert tr._epoch_fns
    ref = weakref.ref(tr)
    gc.disable()
    try:
        del tr
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the EMA's device flag
# ---------------------------------------------------------------------------

def test_ema_first_observation_copies_then_blends():
    clients, devices, cuts = _setup(tlat, tpart)
    groups = thuscf.group_by_profile(devices, cuts)
    mids = iter([{g.name: torch.full((g.size, 2), float(v + i))
                  for i, g in enumerate(groups)} for v in (1.0, 11.0)])

    def step_core(state, batch):
        return {"loss_d": torch.tensor(0.5)}, next(mids)

    epoch = thuscf.make_epoch_fn(groups, step_core, lambda gen: None, 1)
    ema = torch.full((3, 2), 7.0)
    flag = torch.zeros((), dtype=torch.bool)
    losses = {"loss_d": torch.zeros(())}
    state = {"G": {}, "D": {}, "step": 0,
             **{o: thuscf.AdamState(torch.zeros((), dtype=torch.int32),
                                    {}, {}) for o in ("opt_g", "opt_d")}}
    epoch(state, None, ema, flag, losses)
    first = {cid: 1.0 + i for i, g in enumerate(groups) for cid in
             g.client_ids}
    for cid, v in first.items():
        assert torch.equal(ema[cid], torch.full((2,), v))
    assert bool(flag) and float(losses["loss_d"]) == 0.5
    epoch(state, None, ema, flag, losses)
    for i, g in enumerate(groups):
        for cid in g.client_ids:
            want = 0.8 * torch.full((2,), first[cid]) + 0.2 * (11.0 + i)
            assert torch.equal(ema[cid], want)


# ---------------------------------------------------------------------------
# a state replaced from outside
# ---------------------------------------------------------------------------

def _new_cuts(cuts):
    return [tlat.Cut(2, 4, 2, 4) if c == tlat.Cut(1, 3, 1, 3)
            else tlat.Cut(1, 3, 1, 3) for c in cuts]


@pytest.mark.parametrize("event", ["federate", "assign", "rebuild"])
def test_replaced_state_is_the_one_the_fused_epoch_trains(event):
    runs = []
    for fused in (True, False):
        tr = _trainer(fused, warmup_fed_rounds=1)
        tr.train_steps(1)
        if event == "federate":
            tr.federate()
        elif event == "assign":
            # a checkpoint-style load: new tensors, Adam's steps as ints
            st = state_to_numpy(tr.state)
            st["D"]["server"] = tree_map(lambda a: a * 0.5,
                                         st["D"]["server"])
            tr.state = state_from_numpy(st, "cpu")
        else:
            tr._rebuild_population(tr.clients, tr.devices,
                                   _new_cuts(tr.cuts),
                                   old_of=list(range(len(tr.clients))))
        runs.append((tr, tr.train_steps(STEPS)))
    (f, mf), (lp, ml) = runs
    assert mf == ml
    assert all(_equal_bits(x, y) for (_, x), (_, y) in
               zip(_leaves(f), _leaves(lp)))
    assert torch.equal(f._mid_ema, lp._mid_ema)


# ---------------------------------------------------------------------------
# epoch_unroll through the card's control flow
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unrolled():
    """Per unroll (None = the step loop): two epochs of 3 steps through a
    stand-in graph pool; the trainer and the pool."""
    out = {}
    for unroll in (None, 1, 2, 3):
        tr = _trainer(unroll is not None, epoch_unroll=unroll)
        pool = FakePool()
        tr._graph_pool = pool
        tr.train_steps(STEPS)
        tr.train_steps(STEPS)
        out[unroll] = (tr, pool)
    return out


@pytest.mark.parametrize("unroll,captures,replays", [
    (1, 1, [2, 3]), (2, 2, [1, 2]), (3, 2, [1, 1])])
def test_epoch_unroll_gives_the_same_epoch(unrolled, unroll, captures,
                                           replays):
    """Two epochs of 3 steps: the first is an eager warm-up step and
    graphs of ``unroll`` steps with a remainder graph (2 left: [1, 1],
    [2], [2]); the second replays graphs of 3 steps' worth ([1, 1, 1],
    [2, 1], [3]), capturing what it lacks."""
    tr, pool = unrolled[unroll]
    want, _ = unrolled[None]
    assert all(_equal_bits(x, y) for (_, x), (_, y) in
               zip(_leaves(tr), _leaves(want)))
    assert torch.equal(tr._mid_ema, want._mid_ema)
    assert pool.sizes == replays and len(pool.captures) == captures
    assert tr.state["step"] == int(tr.state["opt_g"].step) == 2 * STEPS


def test_a_graph_refuses_another_carry():
    tr = _trainer(True)
    tr._graph_pool = FakePool()
    tr.train_steps(2)
    epoch = tr._epoch_fns[2]
    other = {**tr.state, "opt_d": tr.state["opt_d"]._replace(
        step=tr.state["opt_d"].step.clone())}
    with pytest.raises(RuntimeError, match="other tensors"):
        epoch(other, tr._train_gen, tr._mid_ema, tr._ema_flag, tr._losses)


# ---------------------------------------------------------------------------
# against the reference's fused epoch
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference_runs():
    """Both packages' fused epochs, two of 2 steps, from the port's
    initial state (2 clients in one profile group)."""
    cfg = dict(batch=2, steps_per_epoch=2, federate_every=10 ** 6, seed=0,
               lr=LR)
    clients_t, devices_t, cuts_t = _setup(tlat, tpart, 2)
    start = thuscf.HuSCFTrainer(clients_t, devices_t, cuts=cuts_t,
                                config=thuscf.HuSCFConfig(**cfg),
                                device="cpu").state
    clients, devices, cuts = _setup(jlat, jpart, 2)
    ref = reference_trainer(jhuscf.HuSCFTrainer, state_to_numpy(start),
                            clients, devices, cuts=cuts,
                            config=jhuscf.HuSCFConfig(**cfg))
    assert ref.cfg.fused_epoch
    key = jax.random.PRNGKey(cfg["seed"] + 1)
    sample = jax.jit(ref._sample)
    batches = []
    for _ in range(4):
        key, ks = jax.random.split(key)
        batches.append(_np(sample(ref._dataset, ks)))
    it = iter(batches)

    def source():
        return {f: {g: torch.tensor(a) for g, a in d.items()}
                for f, d in next(it).items()}

    port = thuscf.HuSCFTrainer(clients_t, devices_t, cuts=cuts_t,
                               config=thuscf.HuSCFConfig(**cfg),
                               device="cpu", batch_source=source)
    assert port.cfg.fused_epoch
    port.state = state_from_numpy(_np(ref.state), "cpu")
    out = []
    for _ in range(2):
        m = (ref.train_steps(2), port.train_steps(2))
        out.append({"metrics": m, "ema": (ref.middle_activations(),
                                          port.middle_activations()),
                    "state": (_np(ref.state), state_to_numpy(port.state))})
    return out


@pytest.mark.parametrize("epoch", [0, 1])
def test_fused_epoch_matches_reference(reference_runs, epoch):
    r = reference_runs[epoch]
    m_ref, m_port = r["metrics"]
    if epoch == 0:
        # a loss one Adam step in; later ones follow the parameters'
        # drift, which the bound below holds
        for k in ("loss_d", "loss_g"):
            assert abs(m_port[k] - m_ref[k]) <= 1e-4 * abs(m_ref[k])
    e_ref, e_port = r["ema"]
    np.testing.assert_allclose(e_port, e_ref, rtol=0, atol=1e-3)
    s_ref, s_port = r["state"]
    assert s_port["step"] == s_ref["step"] == 2 * (epoch + 1)
    assert int(s_port["opt_d"].step) == int(s_ref["opt_d"].step)
    n = 2 * (epoch + 1)
    worst = 0.0
    for net in ("G", "D"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                s_ref[net])[0]:
            sub = s_port[net]
            for p in path:
                sub = sub[p.key]
            worst = max(worst, float(np.abs(sub - leaf).max()))
    assert worst <= 2 * n * LR


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,printed,fused", [
    ([], "fused epochs", True), (["--per-step"], "per-step epochs", False)])
def test_launcher_prints_its_epoch_mode(capsys, flags, printed, fused):
    tr = ttrain.main(["--arch", "huscf-gan", "--device", "cpu", "--clients",
                      "4", "--base-size", "24", "--batch", "4", "--epochs",
                      "1", "--federate-every", "5"] + flags)
    out = capsys.readouterr().out
    assert printed in out and tr.cfg.fused_epoch is fused
    assert len(tr.history) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_graph_epoch_matches_step_loop_on_card(cuda):
    """One graph epoch (after the warm-up epoch) and the step loop from
    one state and generator: parameters within 2 lr per step and the
    graphs captured once."""
    tr = _trainer(True, device=cuda)
    tr.train_steps(STEPS)
    assert tr._graph_pool.graphs == 1
    state = state_to_numpy(tr.state)
    ema, gen = tr._mid_ema.clone(), tr._train_gen.get_state()
    graph = tr.train_steps(STEPS)
    got = state_to_numpy(tr.state)
    tr.cfg.fused_epoch = False
    tr.state = state_from_numpy(state, cuda)
    tr._mid_ema = ema
    tr._train_gen.set_state(gen)
    loop = tr.train_steps(STEPS)
    want = state_to_numpy(tr.state)
    for k in graph:
        assert abs(graph[k] - loop[k]) <= 1e-2 * abs(loop[k])
    # Adam moves a parameter by at most ~1.5 lr a step at steps 4-6
    # (b1 = 0.5), whatever its gradient; BatchNorm statistics follow the
    # activations and are not compared
    for net in ("G", "D"):
        for (path, a), (_, b) in zip(tree_items(got[net]),
                                     tree_items(want[net])):
            if path[-1] not in ("mean", "var"):
                assert np.abs(a - b).max() <= 2 * STEPS * 1.5 * LR
    assert tr._graph_pool.graphs == 1


@pytest.mark.cuda
def test_batch_source_on_card_raises(cuda):
    clients, devices, cuts = _setup(tlat, tpart)
    tr = thuscf.HuSCFTrainer(clients, devices, cuts=cuts, device=cuda,
                             config=thuscf.HuSCFConfig(batch=2),
                             batch_source=lambda: None)
    with pytest.raises(ValueError, match="batch_source"):
        tr.train_steps(1)
