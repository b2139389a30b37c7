"""A tiny cell added to a copy of the benchmark as files alone (a
configuration, a limits file and two entries of ``BENCHMARK.json``), for
the CPU tests: 4 clients at Table 3's widths, 12 images each, batch 4,
a round after every epoch over a cohort of 3, aggregation in chunks of
2. Its limits are the CPU's, at this size."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_LIMITS = {"loss_d1_gap": 1e-5, "loss_gap": 2e-2, "grad_d_gap": 1e-3,
               "grad_g_gap": 2e-2, "change_gap": 0.1, "ema_gap": 2e-3,
               "round_weight_gap": 1e-4, "round_theta_gap": 3e-5,
               "round_k_gap": 0, "round_pair_gap": 0, "round_cost_gap": 1e-9,
               "round_untouched_changed": 0}


def make(dst: Path, workload: str = "tiny-train") -> Path:
    """A copy of the benchmark under ``dst`` with the tiny cell added."""
    dst = Path(dst)
    shutil.copytree(REPO / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench/configs/huscf-gan-100.json")
                     .read_text())
    cfg.update(name="tiny", clients=4, base_size=12, batch=4,
               federate_every=1, cohort=3, agg_chunk=2)
    (dst / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    mix = json.loads((REPO / "portbench/traffic/train-paper.json")
                     .read_text())
    mix.update(steps_before_judged_round=1, trace_epochs=1)
    (dst / "portbench/traffic/tiny-mix.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": workload, "config": "tiny",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "CPU tests"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    (dst / f"portbench/limits/{workload}.json").write_text(
        json.dumps({"limits": TINY_LIMITS}))
    return dst
