#!/usr/bin/env python3
"""The arch x input-shape table of a ``python -m repro_torch.launch.dryrun
--all --both-meshes`` run, one cell per pair: the roofline's bound
seconds per card, its dominant term (c compute, m memory, n collective),
the peak GiB per card and the trace's seconds, or ``skip`` / ``error``.

    python3 scripts/dryrun_table.py RECORDS.jsonl

The terms come from ``repro_torch.launch.roofline.analyze_record`` (one
H100's constants, for a hypothetical cluster of such cards); the trace
seconds are the record's ``compile_s``. Prints a markdown table.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import INPUT_SHAPES, list_archs  # noqa: E402
from repro_torch.launch.roofline import analyze_record  # noqa: E402

TERM = {"compute_s": "c", "memory_s": "m", "collective_s": "n"}


def cell(rec) -> str:
    if rec is None:
        return "missing"
    if "skipped" in rec:
        return "skip"
    if "error" in rec:
        return "error"
    a = analyze_record(rec)
    return (f"{a['bound_s']:.3g} {TERM[a['dominant']]} "
            f"{rec['memory']['peak_bytes'] / 2**30:.3g} "
            f"({rec['compile_s']:g} s)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    recs = {}
    with open(argv[0]) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["multi_pod"])] = r
    cols = [(s, mp) for mp in (False, True) for s in INPUT_SHAPES]
    head = [f"{s.split('_')[0]} {'2p' if mp else '1p'}" for s, mp in cols]
    print("| arch | " + " | ".join(head) + " |")
    print("|---" * (len(cols) + 1) + "|")
    for arch in list_archs():
        print(f"| {arch} | " + " | ".join(
            cell(recs.get((arch, s, mp))) for s, mp in cols) + " |")


if __name__ == "__main__":
    main()
