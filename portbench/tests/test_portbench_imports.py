"""What the harness loads: no JAX and not the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), a reference that imports nothing of the program, and no
result without a card or without the program."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_harness_imports_jax():
    for path in PB.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "math", "typing", "torch"}
    for path in (PB / "reference").glob("*.py"):
        for name in _imports(path):
            assert (name.split(".")[0] in allowed
                    or name.startswith("portbench.reference")), (path, name)
    code = ("import sys; import portbench.reference.cgan, "
            "portbench.reference.federation, portbench.reference.counts, "
            "portbench.reference.kmeans, "
            "portbench.reference.peaks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_harness_loads_no_jax_while_it_runs():
    code = """
import sys, torch
torch.set_num_threads(1)
from portbench import registry, calibrate, series
from portbench.tests import tiny
import tempfile
root = tiny.make(tempfile.mkdtemp())
bench = registry.load(root)
for m in bench["end_to_end"] + bench["per_layer"]:
    registry.reader(m["name"], root)
c = registry.cell(bench, "tiny-train", root)
run = registry.driver(c["mix"]["kind"], root).Cell(c["config"], c["mix"], 3,
                                                  "cpu")
from portbench import program, scenario
tr = program.build_trainer(c["config"], scenario.build(
    "2dom_noniid", 4, 12, 28, 3), 3, "cpu")
tr.train_epoch()
tr.federate()
print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "gan100-train",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench.run import run_cell; "
            "print(run_cell('gan100-train', 5, 1, False, 'cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
