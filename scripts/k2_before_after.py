#!/usr/bin/env python3
"""K2 (kmeans_assign) against an earlier build of its CUDA source, and
its time at every split count, on one NVIDIA GPU, in one process.

    python3 scripts/k2_before_after.py [--before OLD.cu]

OLD.cu is an earlier ``src/repro_torch/csrc/kmeans_assign.cu`` whose C
entry point is ``kmeans_assign_f32(x, c, labels, N, M, D, stream)`` (the
one-block-per-row kernel), e.g. extracted with
``git show <commit>:src/repro_torch/csrc/kmeans_assign.cu``. The script
builds it with the port's nvcc flags into ``build/kernels`` (beside the
current kernel, which ``repro_torch.kernels.build`` builds), checks that
both give the plain version's labels, and times both at the shapes
``chip_smoke.py`` times (the training path's N=8 M=4, the JAX kernel
benchmark's N=256 M=4, a population of N=4096 at M=6; D=6272) in turns
before, current, current, before: the device time per launch from
torch.profiler and the CUDA-event loop. Then it times the current kernel
at each split count of D from 1 to 32 (its C entry point called with
each count, not only the one ``assign_splits`` picks), checking the
labels at each. It prints the card's name and power limit, then one
JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"train": (8, 4, 6272), "kernel_bench_256": (256, 4, 6272),
          "population_4096": (4096, 6, 6272)}


def load_before(path: str):
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "libkmeans_assign_before.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), path],
                   check=True)
    fn = ctypes.CDLL(str(out)).kmeans_assign_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before",
                    help="an earlier kmeans_assign.cu (one block per row)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import device_ms_per_launch, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels.ref import kmeans_assign_ref, kmeans_split_len

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in build.build(["kmeans_assign"]).get("kmeans_assign",
                                                    "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"current: {line.strip()}", file=sys.stderr)
    before = load_before(args.before) if args.before else None

    def run_before(x, c):
        labels = torch.empty((x.shape[0],), dtype=torch.int32,
                             device=x.device)
        rc = before(x.data_ptr(), c.data_ptr(), labels.data_ptr(),
                    x.shape[0], c.shape[0], x.shape[1],
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier kernel: CUDA error {rc}")
        return labels

    def split_sweep(x, c, want):
        """Device ms per launch of the current kernel at each split count
        that leaves every split at least 4 columns."""
        N, D = x.shape
        M = c.shape[0]
        tiles = -(-N // km.ROWS_PER_BLOCK)
        labels = torch.empty((N,), dtype=torch.int32, device=x.device)
        fn = build.kernel("kmeans_assign")
        res = {}
        for n in (1, 2, 4, 8, 12, 16, 20, 24, 28, 32):
            per = kmeans_split_len(D, n)
            if per < 4:
                continue
            cnt, ws = build.split_scratch(
                x.device, torch.cuda.current_stream().cuda_stream, tiles,
                tiles * -(-M // km.CENTRES_PER_PASS) * n *
                (km.ROWS_PER_BLOCK + 1) * km.CENTRES_PER_PASS)

            def call():
                rc = fn(x.data_ptr(), c.data_ptr(), labels.data_ptr(),
                        ws.data_ptr(), cnt.data_ptr(), N, M, D, n, per,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"kmeans_assign: CUDA error {rc}")
            call()
            if not torch.equal(labels, want):
                raise AssertionError(f"{n} splits differ from the plain "
                                     "version")
            res[n] = device_ms_per_launch(call, "kmeans_assign_kernel",
                                          n=200)
        return res

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for where, (N, M, D) in SHAPES.items():
        # small integers: exact sums, so the labels of every kernel and
        # split count must equal the plain version's
        x = torch.randint(-4, 5, (N, D), generator=gen, device="cuda").float()
        c = torch.randint(-4, 5, (M, D), generator=gen, device="cuda").float()
        want = kmeans_assign_ref(x, c)
        kernels = {"current": km.kmeans_assign}
        if before is not None:
            kernels["before"] = run_before
        for name, fn in kernels.items():
            if not torch.equal(fn(x, c), want):
                raise AssertionError(f"{name} kernel differs from the plain "
                                     f"version at {where}")
        t = {name: [] for name in kernels}
        for name in ("before", "current", "current", "before"):
            if name not in kernels:
                continue
            fn = kernels[name]
            t[name].append({
                "device_ms": device_ms_per_launch(lambda: fn(x, c),
                                                  "kmeans_assign_kernel",
                                                  n=200),
                "ms": time_ms(lambda: fn(x, c), iters=200)})
        out[where] = {"shape": {"N": N, "M": M, "D": D},
                      "splits": km.assign_splits(N, D,
                                                 build.sm_count(0))[0],
                      **t, "by_splits": split_sweep(x, c, want)}
        print(f"{where}: {json.dumps(out[where])}", file=sys.stderr)
    print(json.dumps({"k2_before_after": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
