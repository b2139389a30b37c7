"""Runs of one cell, one process each, one after another, as the check
makes them; prints each run's result line and the spread of every
metric (the distance between the quartiles of ``statistics.quantiles(n=4)``
over the median):

    python -m portbench.series --workload gan100-train --seconds 30 \
        --seeds 11 12 13 14 15 16 [--trace 1] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from portbench.run import ROOT


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    results = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = {"error": p.stderr[-3000:]}
        res.update(seed=seed, rc=p.returncode, wall_s=wall)
        for line in p.stderr.splitlines():
            if line.startswith("set-up phases (s): "):
                res["phases"] = json.loads(line.split(": ", 1)[1])
        results.append(res)
        text = json.dumps(res)
        print(text, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
    names = sorted({k for r in results for k in r.get("metrics", {})})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in results
                if n in r.get("metrics", {})]
        print(f"# {n}: median {statistics.median(vals)!r} spread "
              f"{spread(vals)!r} n {len(vals)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
