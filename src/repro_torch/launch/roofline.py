"""Roofline analysis from dry-run records (port of
``repro.launch.roofline``).

Reads the JSONL written by ``launch.dryrun`` (and ``launch.dryrun_paper``)
and derives, per (arch x shape x mesh):

    compute_s    = FLOPs_per_card / peak bf16 FLOP/s (one H100)
    memory_s     = bytes_per_card / HBM bytes/s
    collective_s = collective_bytes_per_card / NVLink bytes/s

The records count per rank (each rank is one card), so the "chips x"
normalisation is already applied. The constants are one NVIDIA H100
SXM5 80GB's at 700 W (``launch.mesh``); the terms are derived for a
hypothetical cluster of such cards, not measured.

Also reports MODEL_FLOPS = 6 N_active D_tokens (train) or 2 N_active
D_tokens (inference) against the counted FLOPs: the useful-compute
ratio that exposes recomputation and dispatch waste. Records from
either package read the same way: the keys are the reference's.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch.mesh import (CARD_HBM_BYTES, HBM_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)


def model_flops_per_device(arch: str, shape_name: str, chips: int) -> float:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / chips


def analyze_record(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if "skipped" in rec or "error" in rec:
        return None
    if "cost_corrected" in rec:   # the dry run's scan calibration
        flops = rec["cost_corrected"]["flops"]
        bytes_acc = rec["cost_corrected"]["bytes"]
        coll = rec["cost_corrected"]["coll"]
    else:
        flops = rec["cost"].get("flops", 0.0)
        bytes_acc = rec["cost"].get("bytes_accessed", 0.0)
        coll = rec["collectives"].get("total", 0.0)
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_acc / HBM_BW
    collective_s = coll / NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    # a record of a shape or an arch outside the catalog (a cut config's
    # own shape) has no model FLOPs
    if rec["arch"] in list_archs() and rec["shape"] in INPUT_SHAPES:
        mf = model_flops_per_device(rec["arch"], rec["shape"], rec["chips"])
        useful = mf / flops if flops else 0.0
    else:
        mf = useful = None
    peak = rec.get("memory", {}).get("peak_bytes", 0)
    return dict(rec, **terms, dominant=dominant,
                model_flops=mf, useful_ratio=useful,
                bound_s=max(terms.values()),
                fits_hbm=bool(peak <= CARD_HBM_BYTES),
                hbm_frac=peak / CARD_HBM_BYTES)


def what_would_help(row: Dict[str, Any]) -> str:
    d = row["dominant"]
    if d == "collective_s":
        return ("reduce resharding: fewer FSDP gathers / keep residents "
                "sharded; overlap collectives with compute")
    if d == "memory_s":
        if row["kind"] == "decode":
            return "decode is cache-streaming bound: shrink/quantize KV cache"
        return "recompute less / fuse more; raise arithmetic intensity"
    if row["useful_ratio"] is not None and row["useful_ratio"] < 0.4:
        return "compute-bound but wasteful: cut remat or MoE over-capacity"
    return "near compute roofline: only larger per-chip batch helps"


def load(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            rows.append(json.loads(line))
    # dedup keeping the latest record per key
    best = {}
    for r in rows:
        best[(r["arch"], r["shape"], r["multi_pod"])] = r
    return list(best.values())


def markdown_table(rows: List[Dict[str, Any]], multi_pod: bool = False
                   ) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/HLO | HBM frac | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["multi_pod"] != multi_pod:
            continue
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped |"
                       f" — | — | {r['skipped'][:60]} |")
            continue
        a = analyze_record(r)
        if a is None:
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | "
                       f"{r.get('error','')[:60]} |")
            continue
        useful = ("—" if a["useful_ratio"] is None
                  else f"{a['useful_ratio']:.2f}")
        out.append(
            f"| {a['arch']} | {a['shape']} | {a['compute_s']:.2e} | "
            f"{a['memory_s']:.2e} | {a['collective_s']:.2e} | "
            f"{a['dominant'].replace('_s','')} | {useful} | "
            f"{a['hbm_frac']:.2f} | {what_would_help(a)[:70]} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.path)
    print(markdown_table(rows, args.multi_pod))


if __name__ == "__main__":
    main()
