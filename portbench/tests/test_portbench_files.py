"""The benchmark finds every cell's files by name, a cell, a mix, a
metric and a kind of mix with its driver added as files alone are picked
up, and BENCHMARK.json keeps to its contract."""
import json
import re

import pytest

from portbench import registry
from portbench.run import run_cell
from portbench.tests import tiny

BENCH = registry.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(workload):
    c = registry.cell(BENCH, workload)
    assert c["config"]["name"] == c["workload"]["config"]
    drv = registry.driver(c["mix"]["kind"])
    assert callable(drv.Cell)
    assert set(c["limits"]["limits"]) >= {"loss_d1_gap", "round_pair_gap"}
    for trace in (False, True):
        for m in registry.metrics(BENCH, workload, trace):
            assert callable(registry.reader(m["name"]))


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    root = tiny.make(tmp_path)
    (root / "portbench/traffic/tiny-mix2.json").write_text(json.dumps(
        {**registry.cell(BENCH, "gan100-train")["mix"], "trace_epochs": 2}))
    (root / "portbench/metrics/tiny_epochs.py").write_text(
        "def read(ctx):\n    return ctx.window['epochs']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][-1]["traffic"] = "tiny-mix2"
    bench["per_layer"].append({"name": "tiny_epochs", "unit": "epochs",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.load(root)
    c = registry.cell(bench, "tiny-train", root)
    assert c["config"]["clients"] == 4 and c["mix"]["trace_epochs"] == 2
    names = [m["name"] for m in registry.metrics(bench, "tiny-train", True)]
    assert "tiny_epochs" in names and "round_ms" not in names
    ctx = type("Ctx", (), {"window": {"epochs": 3}})
    assert registry.reader("tiny_epochs", root)(ctx) == 3
    assert "tiny_epochs" not in [
        m["name"] for m in registry.metrics(bench, "gan100-train", True)]


def test_configs_state_every_size_the_reference_reads():
    for c in BENCH["configs"]:
        cfg = json.loads((registry.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for k in cfg["reduced"]:
            assert not k.endswith(("_dim", "_rank"))
        assert cfg["model"]["dtype"] == "float32" and not cfg["model"]["tf32"]


ECHO_DRIVER = """
import time
import torch


class Cell:
    def __init__(self, cfg, mix, seed, device, trace=False):
        self.n, self.reps = cfg["n"], mix["reps"]
        self.gen = torch.Generator().manual_seed(seed)
        self.trace_summary, self.phases = None, {}

    def setup(self):
        self.x = torch.randn(self.n, self.n, generator=self.gen,
                             dtype=torch.float64)

    def window(self, seconds):
        t0, done = time.perf_counter(), 0
        while True:
            self.y = self.x
            for _ in range(self.reps):
                self.y = self.y @ self.x / self.n
            done += 1
            if time.perf_counter() - t0 >= seconds:
                return {"seconds": time.perf_counter() - t0,
                        "attempted": done, "failed": 0, "products": done}

    def close(self):
        pass

    def judge(self):
        ref = torch.linalg.matrix_power(self.x / self.n, self.reps) * self.n
        return {"echo_gap": float((self.y - self.x @ ref / self.n).abs()
                                  .max())}

    def context(self):
        return {}
"""


def test_a_kind_of_mix_added_as_files_is_driven(tmp_path):
    """A mix of a new kind brings its driver, configuration, limits and
    metric as files; the harness runs its cell and leaves out the
    training cells' metrics, which find nothing to read there."""
    root = tiny.make(tmp_path)
    pb = root / "portbench"
    (pb / "drivers/echo.py").write_text(ECHO_DRIVER)
    (pb / "traffic/echo-mix.json").write_text(json.dumps(
        {"kind": "echo", "reps": 3}))
    (pb / "configs/echo.json").write_text(json.dumps({"name": "echo",
                                                      "n": 8}))
    (pb / "limits/echo-cell.json").write_text(json.dumps(
        {"limits": {"echo_gap": 1e-12}}))
    (pb / "metrics/products_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx.window['products'] / ctx.window['seconds']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo", "source": "tests",
                             "file": "portbench/configs/echo.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "echo-cell", "config": "echo",
                               "traffic": "echo-mix", "chips": 1,
                               "why": "CPU tests"})
    bench["end_to_end"].append({"name": "products_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["echo-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell("echo-cell", 5, 0.05, False, "cpu", root)
    assert res["correct"] and res["attempted"] >= 1, res
    assert set(res["metrics"]) == {"products_per_s", "setup_s"}
    assert res["checks"]["echo_gap"]["limit"] == 1e-12
