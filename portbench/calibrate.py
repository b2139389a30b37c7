"""The readings that the limits in ``portbench/limits/<cell>.json`` are
set from, on the card, at the cell's own size, in one process over many
seeds (the benchmark's runs do not run this). Each seed's cell is set up
and closed as a run sets it up and closes it; the cell's driver's
``readings(cell)`` then gives the program's numbers, the control's and
those of the faults it plants in the reference or in what it judges.
``--fault`` plants one of ``program.FAULTS`` in the program first, so
that the program's numbers are that fault's.

    python -m portbench.calibrate --workload gan100-train --seeds 1 2 3 \
        [--fault one_cluster] [--out FILE]

prints one JSON line per seed (and appends it to ``--out``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

from portbench.run import ROOT, cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    import torch

    from portbench import program, registry
    if args.fault:
        program.plant(args.fault, setattr)
    c = registry.cell(registry.load(ROOT), args.workload, ROOT)
    drv = registry.driver(c["mix"]["kind"], ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        run = drv.Cell(c["config"], c["mix"], seed, "cuda")
        run.setup()
        setup_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        run.close()
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "setup_s": setup_s,
                "memory_peak_bytes": peak, "phases": run.phases,
                **drv.readings(run, half_batch=not args.fault),
                "card": torch.cuda.get_device_name()}
        del run
        gc.collect()
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
