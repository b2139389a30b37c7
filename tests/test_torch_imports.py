"""The port stands alone: importing every module of ``repro_torch`` and
every ``examples/torch_*.py`` in a fresh interpreter loads no ``jax``
and no module of the JAX package ``repro``, and ``chip_smoke.py``
imports neither anywhere in its source."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, importlib.util, json, os, pkgutil, sys
root = sys.argv[1]
sys.path.insert(0, os.path.join(root, "src"))
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
examples = sorted(f for f in os.listdir(os.path.join(root, "examples"))
                  if f.startswith("torch_") and f.endswith(".py"))
for f in examples:
    spec = importlib.util.spec_from_file_location(
        f[:-3], os.path.join(root, "examples", f))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "examples": examples, "bad": bad}))
"""


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_port_and_example_twins_import_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    assert "repro_torch.core.huscf" in res["modules"]
    for name in ("repro_torch.sharding", "repro_torch.sharding.policy",
                 "repro_torch.launch.mesh"):
        assert name in res["modules"], name
    assert len(res["modules"]) > 40
    assert res["examples"] == ["torch_multi_domain_comparison.py",
                               "torch_quickstart.py", "torch_serve_lm.py",
                               "torch_split_lm_training.py"]


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "examples", "torch_*.py"))))
def test_sources_name_no_jax_and_no_reference(path):
    """Every import statement of the file, at any depth (the smoke
    imports inside its functions)."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            found.append(node.module)
    assert found == []
