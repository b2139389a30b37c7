"""``step_layout_copies``: one traced run of the tiny cell on the CPU
reads the program's count of a step's layout copies as a whole number,
the one its eager step recorded; a program that records no such count
reads nothing."""
import json

import pytest
import torch

from portbench import registry
from portbench.run import run_cell
from portbench.tests import tiny
from repro_torch import trace

SEED = 11


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_traced_run_reads_a_whole_count(tmp_path):
    root = tiny.make(tmp_path)
    path = root / "portbench/configs/tiny.json"
    cfg = json.loads(path.read_text())
    cfg.update(base_size=4, federate_every=2)
    path.write_text(json.dumps(cfg))
    trace.clear()
    res = run_cell("tiny-train", SEED, 3.0, True, "cpu", root)
    got = res["metrics"]["step_layout_copies"]
    assert got["unit"] == "count"
    n = got["value"]
    steps = [r.attrs["layout_copies"] for r in trace.records()
             if r.name == "huscf.train_steps.launch"]
    assert isinstance(n, int) and n > 0 and n == steps[-1]


def test_no_count_reads_nothing():
    trace.clear()
    with trace.span("huscf.train_steps.launch"):
        pass
    read = registry.reader("step_layout_copies")
    assert read(None) is None
