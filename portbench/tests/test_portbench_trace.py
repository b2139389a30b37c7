"""The program's spans in the benchmark's trace and metrics.

* Under a ``torch.profiler`` session a program span is a user
  annotation of the profiler's trace, and ``portbench.trace.summarize``
  names an idle gap of the device inside it by the span's name.
* One traced run of the tiny cell through ``run_cell`` reports every
  metric read from the program's spans and counters; no phase of the
  fused step, whose events exist only in the card's CUDA graphs.
* A window in which the program recorded nothing reads nothing, nor
  one whose records the recorder's ring dropped in part.
"""
import json
import time

import pytest
import torch

from portbench import registry, trace as trace_mod
from portbench.run import run_cell
from portbench.tests import tiny
from repro_torch import trace

SEED = 7
HOST_SPAN_METRICS = {"step_span_ms", "epoch_gap_ms", "round_span_ms",
                     "round_cluster_ms", "round_aggregate_ms",
                     "round_readbacks", "init_state_s", "graph_capture_s"}
DEVICE_PHASE_METRICS = {"step_grad_d_ms", "step_grad_g_ms", "step_adam_ms"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_span_labels_the_idle_gap_inside_it():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("huscf.test.idle"):
            time.sleep(0.02)
        x = torch.ones(4) + 1
    _, host = trace_mod.read_events(prof)
    mine = [h for h in host if h[0] == "huscf.test.idle"]
    assert len(mine) == 1 and float(x[0]) == 2
    _, s, e = mine[0]
    assert e - s >= 0.015
    # device work before and after the span, nothing during it
    dev = [("k0", s - 2e-3, s + 1e-3), ("k1", e - 1e-3, e + 2e-3)]
    summary = trace_mod.summarize(dev, host, s - 2e-3, e + 2e-3)
    assert summary["idle_gaps"][0][0] == "huscf.test.idle"


def test_a_traced_run_reports_the_programs_spans(tmp_path):
    root = tiny.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if "workloads" in m:                # the round metrics' cells
            m["workloads"].append("tiny-train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    # one-step epochs and a round every other epoch: the window holds
    # consecutive epochs with no round between them
    path = root / "portbench/configs/tiny.json"
    cfg = json.loads(path.read_text())
    cfg.update(base_size=4, federate_every=2)
    path.write_text(json.dumps(cfg))
    trace.clear()           # a fresh process's ring: nothing dropped
    res = run_cell("tiny-train", SEED, 6.0, True, "cpu", root)
    got = set(res["metrics"])
    assert got >= HOST_SPAN_METRICS and not got & DEVICE_PHASE_METRICS
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["graph_capture_s"] == 0 and m["init_state_s"] > 0
    assert m["step_span_ms"] <= m["step_ms"]
    assert m["round_cluster_ms"] + m["round_aggregate_ms"] \
        <= m["round_span_ms"] <= m["round_ms"]
    assert isinstance(m["round_readbacks"], int) and m["round_readbacks"] > 0
    names = {x["name"] for x in registry.metrics(
        registry.load(root), "tiny-train", True)}
    assert names >= HOST_SPAN_METRICS | DEVICE_PHASE_METRICS


@pytest.mark.parametrize("name", sorted(HOST_SPAN_METRICS
                                        | DEVICE_PHASE_METRICS))
def test_a_window_without_records_reads_nothing(name):
    now = time.perf_counter()
    spans = [{"name": n, "t0": now + 10 + i, "t1": now + 10.5 + i,
              "profiled": False, "steps": 1}
             for i, n in enumerate(("train_steps", "federate",
                                    "train_steps"))]
    ctx = type("Ctx", (), {"spans": spans})
    assert registry.reader(name)(ctx) is None


def test_a_ring_that_dropped_records_reads_nothing(monkeypatch):
    trace.clear()
    t0 = time.perf_counter()
    with trace.span("huscf.train_steps", steps=2):
        time.sleep(0.002)
    spans = [{"name": "train_steps", "t0": t0,
              "t1": time.perf_counter(), "profiled": False, "steps": 2}]
    ctx = type("Ctx", (), {"spans": spans})
    read = registry.reader("step_span_ms")
    assert read(ctx) >= 1.0
    monkeypatch.setattr(trace.RECORDER, "_dropped", 1)
    assert read(ctx) is None
