"""The port's recorder (``repro_torch.trace``) and what the trainer
records with it.

* Spans nest: each record names the span open around it, a parent
  follows its children, events sit inside the span that was open.
* The ring keeps its last ``size`` records and counts the ones it
  dropped; a paused recorder records nothing.
* One clustered round of a tiny CPU trainer: its ``huscf.readback``
  events, site by site, against its k-means run counted apart (each
  candidate k's seeds, its Lloyd iterations and their re-seeds, its
  silhouette check, and the round's one selection).
* The trainer's set-up, epoch and round spans, and the launcher's
  round line.

Tests marked ``cuda`` skip without a GPU: a captured step's four
phases against events around its replay, and a round's readback count
against the synchronisations torch's sync debug mode reports.
"""
import collections
import warnings

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from repro_torch import trace
from repro_torch.core import clustering
from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
from repro_torch.core.latency import PAPER_DEVICES
from repro_torch.data.partition import build_scenario
from repro_torch.launch import train as ttrain


def _trainer(device="cpu", clients=8):
    specs = build_scenario("2dom_noniid", num_clients=clients, base_size=24,
                           seed=0)
    return HuSCFTrainer(specs, [PAPER_DEVICES[i % 7] for i in range(clients)],
                        config=HuSCFConfig(batch=4, federate_every=100,
                                           seed=0, warmup_fed_rounds=1),
                        device=device)


def _inside(recs, outer):
    return [r for r in recs if outer.t0 <= r.t0 and r.t1 <= outer.t1
            and r is not outer]


def test_spans_nest_and_name_their_parent():
    rec = trace.Recorder()
    with rec.span("a", x=1) as a:
        rec.event("e")
        with rec.span("b"):
            rec.event("f", y=2)
    e, f, b, a_rec = rec.records()
    assert [r.name for r in (e, f, b, a_rec)] == ["e", "f", "b", "a"]
    assert a_rec.parent is None and a_rec.attrs == {"x": 1}
    assert e.parent == a_rec.id and b.parent == a_rec.id
    assert f.parent == b.id and f.attrs == {"y": 2}
    assert e.t0 == e.t1 and a_rec.t0 <= b.t0 <= b.t1 <= a_rec.t1
    assert a.seconds == a_rec.seconds >= b.seconds >= 0


def test_the_ring_keeps_its_last_records_and_counts_the_dropped():
    rec = trace.Recorder(size=4)
    for i in range(7):
        rec.event("e", i=i)
    assert [r.attrs["i"] for r in rec.records()] == [3, 4, 5, 6]
    assert rec.dropped() == 3
    with rec.paused():
        with rec.span("hidden") as sp:
            rec.event("hidden")
    assert len(rec.records()) == 4 and sp.seconds >= 0
    rec.clear()
    assert rec.records() == [] and rec.dropped() == 0


def test_a_clustered_round_counts_every_host_read(monkeypatch):
    """Each candidate k reads its k k-means++ seeds, one convergence test
    per Lloyd iteration after the first assignment, k re-seed indices
    per centre update and one silhouette check; the round reads its
    selection once."""
    tr = _trainer()
    tr.train_epoch()
    tr.federate()                                  # the FedAvg warm-up
    runs = []                     # (k, assignments) of every k-means run
    kmeans, assign = clustering.kmeans, clustering._assign

    def counted_kmeans(x, k, **kw):
        runs.append([k, 0])
        return kmeans(x, k, **kw)

    def counted_assign(*a):
        runs[-1][1] += 1
        return assign(*a)
    monkeypatch.setattr(clustering, "kmeans", counted_kmeans)
    monkeypatch.setattr(clustering, "_assign", counted_assign)
    diag = tr.federate()
    fed = trace.records()[-1]
    assert fed.name == "huscf.federate" and fed.attrs["mode"] == "clustered"
    assert diag["mode"] == "clustered"
    sites = collections.Counter(r.attrs["site"] for r in _inside(
        trace.records(), fed) if r.name == trace.READBACK)
    # a run that converged after u centre updates assigned u + 2 times
    # (u + 1 in the loop, once after it)
    updates = [(k, n - 2) for k, n in runs]
    assert all(0 < u < 49 for _, u in updates)
    assert sites == {
        "kmeans_pp.seed": sum(k for k, _ in updates),
        "kmeans.converged": sum(u for _, u in updates),
        "kmeans.reseed": sum(k * u for k, u in updates),
        "silhouette.valid": len(updates), "cluster.select": 1}


def test_the_trainer_records_its_set_up_epochs_and_rounds(capsys):
    tr = ttrain.main(["--arch", "huscf-gan", "--device", "cpu", "--clients",
                      "4", "--base-size", "12", "--batch", "4", "--epochs",
                      "2", "--federate-every", "1"])
    recs = trace.records()
    init = [r for r in recs if r.name == "huscf.init.state"][-1]
    mine = [r for r in recs if r.t0 >= init.t0]
    names = collections.Counter(r.name for r in mine)
    assert names["huscf.train_steps"] == 2 == names["huscf.federate"]
    assert names["huscf.federate.aggregate"] == 4
    cut = [r for r in recs if r.name == "huscf.init.cut_search"][-1]
    assert cut.seconds == tr.ga_seconds and cut.t1 <= init.t0
    for steps in (r for r in mine if r.name == "huscf.train_steps"):
        kids = {r.name for r in mine if r.parent == steps.id}
        assert kids == {"huscf.train_steps.adopt",
                        "huscf.train_steps.launch",
                        "huscf.train_steps.readback"}
        assert steps.attrs["steps"] == max(1, int(np.median(tr.sizes)) // 4)
    # no CUDA graph on the CPU: no phases of the step
    assert not any(r.name.startswith("huscf.step.") for r in mine)
    for fed in (r for r in mine if r.name == "huscf.federate"):
        kids = [r for r in mine if r.parent == fed.id]
        assert {r.attrs["net"] for r in kids
                if r.name == "huscf.federate.aggregate"} == {"G", "D"}
    out = capsys.readouterr().out
    assert "[train] round (fedavg): cluster 0.0 ms, kld 0.0 ms" in out
    assert " 0 readbacks" in out


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_a_captured_steps_phases_fit_inside_its_replay(cuda):
    tr = _trainer(cuda)
    tr.train_steps(2)                 # the warm-up, then the capture
    assert tr._graph_pool.graphs == 1
    around = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    around[0].record()
    tr.train_steps(1)                 # one replay of the captured step
    around[1].record()
    torch.cuda.synchronize()
    phases = {r.name: r.attrs["ms"] for r in trace.records()[-6:]
              if r.name.startswith("huscf.step.")}
    assert set(phases) == {"huscf.step.grad_d", "huscf.step.adam_d",
                           "huscf.step.grad_g", "huscf.step.adam_g"}
    assert all(v > 0 for v in phases.values()), phases
    assert sum(phases.values()) <= around[0].elapsed_time(around[1])


@pytest.mark.cuda
def test_a_rounds_readbacks_are_its_synchronisations(cuda):
    tr = _trainer(cuda, clients=20)
    tr.train_epoch()
    tr.federate()                     # FedAvg: builds the plans
    tr.train_epoch()
    tr.federate()                     # the first clustered round
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr.federate()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    fed = trace.records()[-1]
    assert fed.name == "huscf.federate" and fed.attrs["mode"] == "clustered"
    reads = [r for r in _inside(trace.records(), fed)
             if r.name == trace.READBACK]
    assert len(reads) == len(syncs) > 0, collections.Counter(
        f"{w.filename}:{w.lineno}" for w in syncs)
