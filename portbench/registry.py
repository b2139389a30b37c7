"""Finding a cell's files by the names in ``BENCHMARK.json``: its
configuration (the entry's ``file``), its traffic mix
(``portbench/traffic/<traffic>.json``), the driver its mix's ``kind``
names (``portbench/drivers/<kind>.py``), its limits
(``portbench/limits/<workload>.json``) and one reader per metric
(``portbench/metrics/<metric>.py``, a function ``read(ctx)``)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str, root: Path = ROOT) -> Dict:
    """The workload's entry, configuration, mix and limits."""
    root = Path(root)
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    return {"workload": w,
            "config": json.loads((root / c["file"]).read_text()),
            "mix": json.loads((root / "portbench" / "traffic"
                               / f"{w['traffic']}.json").read_text()),
            "limits": json.loads((root / "portbench" / "limits"
                                  / f"{workload}.json").read_text())}


def metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics the cell reports: its end-to-end ones without the
    trace, its per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    return _load(Path(root) / "portbench" / "metrics" / f"{name}.py",
                 f"portbench_metric_{name}").read


def driver(kind: str, root: Path = ROOT):
    """The module ``portbench/drivers/<kind>.py``: its ``Cell`` drives the
    cells of every mix of that kind (``portbench.drivers`` gives the
    protocol)."""
    return _load(Path(root) / "portbench" / "drivers" / f"{kind}.py",
                 f"portbench_driver_{kind}")
