"""The port's roofline analysis (``repro_torch.launch.roofline``) against
the JAX package's on the same records.

The reference reads its TPU constants from ``repro.launch.mesh``; the
test sets the four names in its imported ``repro.launch.roofline`` to
the port's H100 values (``monkeypatch``, nothing in the JAX package is
edited), so both derive the same terms. Every field of
``analyze_record``, ``what_would_help`` and the ``markdown_table`` text
must be equal, and ``model_flops_per_device`` equal for every arch and
shape at 256 and 512 cards. Exact.
"""
import json

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import INPUT_SHAPES, list_archs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402


@pytest.fixture
def ref(monkeypatch):
    from repro.launch import roofline as rroof
    monkeypatch.setattr(rroof, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(rroof, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(rroof, "ICI_BW", tmesh.NVLINK_BW)
    monkeypatch.setattr(rroof, "CHIP_HBM_BYTES", tmesh.CARD_HBM_BYTES)
    return rroof


def _records():
    """Synthetic dry-run records: every kind, both meshes, skipped and
    error pairs, with and without ``cost_corrected``, a collective-bound,
    a memory-bound decode, a wasteful and a lean compute-bound one, and
    a record that does not fit a card."""
    out = []
    for i, (arch, shape) in enumerate(
            (a, s) for a in list_archs() for s in INPUT_SHAPES):
        for mp in (False, True):
            chips = 512 if mp else 256
            base = {"arch": arch, "shape": shape, "multi_pod": mp,
                    "kind": INPUT_SHAPES[shape].kind, "chips": chips}
            k = (i * 7 + mp) % 9
            if k == 0:
                out.append(dict(base, skipped=f"reason {i}"))
                continue
            if k == 1:
                out.append(dict(base, error=f"RuntimeError: op {i} " * 8))
                continue
            # counted FLOPs 1.2x (lean) or 5x (wasteful) the model's;
            # bytes and collective bytes pick the dominant term
            flops = troof.model_flops_per_device(arch, shape, chips) * (
                1.2 if k % 2 else 5.0)
            nbytes, coll = {0: (flops / 1e3, flops / 1e4),
                            1: (flops / 10, flops / 1e4),
                            2: (flops / 1e3, flops / 10)}[k % 3]
            rec = dict(base, cost={"flops": flops, "bytes_accessed": nbytes},
                       collectives={"total": coll},
                       memory={"peak_bytes": int(flops / 40 * (1 + mp))})
            if k % 2:
                rec["cost_corrected"] = {"flops": 1.5 * flops,
                                         "bytes": 1.5 * nbytes,
                                         "coll": 1.5 * coll}
            if k == 4:      # missing cost keys fall back to 0
                rec["cost"] = {"flops": flops}
            out.append(rec)
    return out


def test_analyze_and_advice_match(ref):
    recs = _records()
    kinds = set()
    for rec in recs:
        got, want = troof.analyze_record(rec), ref.analyze_record(rec)
        assert got == want, rec
        if got is not None:
            kinds.add(got["dominant"])
            assert troof.what_would_help(got) == ref.what_would_help(want)
    assert kinds == {"compute_s", "memory_s", "collective_s"}
    advice = {troof.what_would_help(troof.analyze_record(r))
              for r in recs if troof.analyze_record(r) is not None}
    assert len(advice) == 5


@pytest.mark.parametrize("multi_pod", [False, True])
def test_markdown_table_matches(ref, multi_pod):
    recs = _records()
    got = troof.markdown_table(recs, multi_pod)
    assert got == ref.markdown_table(recs, multi_pod)
    assert "skipped" in got and "ERROR" in got


def test_load_keeps_the_latest_record(ref, tmp_path):
    recs = _records()
    path = tmp_path / "d.jsonl"
    # every key twice, the second record a changed copy of the first
    with open(path, "w") as f:
        for r in recs + [dict(r, wall_s=9.0) for r in recs]:
            f.write(json.dumps(r) + "\n")
    got, want = troof.load(str(path)), ref.load(str(path))
    assert got == want
    assert len(got) == len(recs) and all(r["wall_s"] == 9.0 for r in got)
    assert troof.markdown_table(got) == ref.markdown_table(want)


@pytest.mark.parametrize("chips", [256, 512])
def test_model_flops_per_device_matches(ref, chips):
    for arch in list_archs():
        for shape in INPUT_SHAPES:
            assert (troof.model_flops_per_device(arch, shape, chips)
                    == ref.model_flops_per_device(arch, shape, chips)), \
                (arch, shape)


def test_main_prints_the_table(ref, tmp_path, capsys):
    recs = _records()
    path = tmp_path / "d.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    troof.main([str(path), "--multi-pod"])
    assert capsys.readouterr().out.strip() == ref.markdown_table(
        ref.load(str(path)), True)


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "smoke_train"),
                                        ("huscf-lm:granite-3-2b",
                                         "split_train_s1024")])
def test_record_outside_the_catalog(arch, shape):
    """A record of a shape or an arch the catalog does not hold (a cut
    config's own shape, the split LM) gets the three terms and no model
    FLOPs; its table row says so."""
    rec = {"arch": arch, "shape": shape, "multi_pod": False,
           "kind": "train", "chips": 1,
           "cost": {"flops": 2e12, "bytes_accessed": 1e9},
           "collectives": {"total": 0.0},
           "memory": {"peak_bytes": 2 ** 30}}
    a = troof.analyze_record(rec)
    assert a["model_flops"] is None and a["useful_ratio"] is None
    assert a["compute_s"] == 2e12 / tmesh.PEAK_FLOPS_BF16
    assert a["memory_s"] == 1e9 / tmesh.HBM_BW
    assert a["bound_s"] == max(a["compute_s"], a["memory_s"])
    assert a["dominant"] == "compute_s"
    row = troof.markdown_table([rec]).splitlines()[-1]
    assert row.startswith(f"| {arch} | {shape} |") and "| — |" in row
    assert troof.what_would_help(a).startswith("near compute roofline")
