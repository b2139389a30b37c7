"""Run one cell of the port's benchmark and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Without a card (or with fewer cards than
the cell asks for) it exits with code 2 and prints no result. With one,
it sets the cell up from the seed, measures ``--seconds`` of training,
and judges what the timed path produced against the plain reference:
the last lines of standard error give each number compared beside its
limit, and the last line of standard output is the result's JSON
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``). A run whose process
holds JAX or the JAX package once the window has closed exits with
code 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


def banned_modules():
    """Top-level module names in this process that the benchmark may not
    load: JAX's and the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed place inside the
    checkout (the CUDA kernels build into ``build/kernels`` there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             t_start: float = None) -> dict:
    """One run of ``workload``: returns the result (with the numbers
    compared under ``checks``). The cell's mix names its driver by its
    ``kind`` (``portbench/drivers/<kind>.py``). ``device="cpu"`` runs it
    on the CPU, for tests at tiny sizes."""
    import torch

    from portbench import check, registry

    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.load(root)
    c = registry.cell(bench, workload, root)
    cfg, mix = c["config"], c["mix"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    run = registry.driver(mix["kind"], root).Cell(cfg, mix, seed, device,
                                                  trace=trace)
    t_setup = time.perf_counter()
    run.setup()
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    run.close()

    t0 = time.perf_counter()
    numbers = run.judge()
    t_ref = time.perf_counter() - t0
    correct, shown = check.judge(numbers, c["limits"]["limits"])

    ctx = SimpleNamespace(setup_s=setup_s, window=win, memory_peak_bytes=peak,
                          trace=run.trace_summary, config=cfg,
                          **run.context())
    metrics = {}
    for m in registry.metrics(bench, workload, trace):
        v = registry.reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(torch.device(device))
                    if on_card else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace and run.trace_summary is not None:
        dev["busy_s"] = run.trace_summary["busy_s"]
        dev["window_s"] = run.trace_summary["window_s"]
        result["breakdown"] = {
            "device_ops": run.trace_summary["device_ops"],
            "idle_gaps": run.trace_summary["idle_gaps"]}
    result["checks"] = shown
    result["_phases"] = {"start": t_setup - t_start, **run.phases,
                         "reference": t_ref}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    import torch

    from portbench import registry
    chips = {w["name"]: w for w in registry.load(ROOT)["workloads"]}[
        args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", ROOT, T_START)
    found = banned_modules()
    if found:
        print(f"portbench: this process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("set-up phases (s): " + json.dumps(result.pop("_phases")),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
