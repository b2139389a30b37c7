"""A tiny cell on the CPU, through the harness: the timed path agrees
with the plain reference, the reference in TF32 (the control) does
not, and a timed path broken underneath reads ``correct`` false (one
chip: the cells have no exchange between chips to leave out)."""
import pytest
import torch

from portbench import check, program, registry
from portbench.run import run_cell
from portbench.tests import tiny

SEED = 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_program_agrees_with_the_reference_and_the_control_does_not(
        tmp_path):
    root = tiny.make(tmp_path)
    c = registry.cell(registry.load(root), "tiny-train", root)
    drv = registry.driver(c["mix"]["kind"], root)
    run = drv.Cell(c["config"], c["mix"], SEED, "cpu")
    run.setup()
    run.close()
    r = drv.readings(run, half_batch=False)
    limits = c["limits"]["limits"]
    ok, shown = check.judge(r["program"], limits)
    assert ok, shown
    ok, shown = check.judge(r["control"], limits)
    assert not ok, shown
    # (the tiny cell's round puts its 4 clients in one cluster: the
    # clustering's faults are read at the cells' sizes on the card, and
    # in test_portbench_kmeans)
    for fault in ("round_uniform", "round_skipped", "round_all_owners"):
        assert not check.judge(r[fault], limits)[0], fault


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "weights_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    program.plant(fault, monkeypatch.setattr)
    res = run_cell("tiny-train", SEED, 0.1, False, "cpu", tiny.make(tmp_path))
    assert not res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-2] == "checks"
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
