#!/usr/bin/env python3
"""K1 (clustered_agg) against an earlier build of its CUDA source and
against torch.matmul, on one NVIDIA GPU, in one process.

    python3 scripts/k1_before_after.py [--before OLD.cu]

OLD.cu is an earlier ``src/repro_torch/csrc/clustered_agg.cu`` whose C
entry point is ``clustered_agg_f32(w, theta, out, S, K, D, vec4, stream)``
(contiguous theta, W staged whole in shared memory), e.g. extracted with
``git show <commit>:src/repro_torch/csrc/clustered_agg.cu``. The script
builds it with the port's nvcc flags into ``build/kernels`` beside the
current kernel, checks both against the plain version, and times them at
the training path's shapes: the population's chunk tiles ``[S, 64] @
[64, D_G]`` at S = 24 (k_max = 6 clusters x 4 owned layers) and S = 8
(k = 2, the shape the population's rounds launch), the slice's
``[16, 8] @ [8, D_G]``, S = 1 (a FedAvg average), and a dense round of
2560 clients at ``[24, 2560] @ [2560, D_D]`` (above the earlier kernel's
shared-memory cap, so it times the current kernel alone). theta is a
view of a buffer whose rows are padded as the federation plan pads
them; the earlier kernel takes its contiguous copy. Turns
run before, current, current, before, each the device time per launch
from torch.profiler; torch.matmul and the plain version are timed
beside, with the byte bound and the float32 FMA time. It prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_G, D_D = 2_050_405, 671_585      # the 8-client slice's client widths
SHAPES = {"chunk_s24": (24, 64, D_G), "chunk_s8": (8, 64, D_G),
          "slice": (16, 8, D_G), "fedavg_s1": (1, 8, D_G),
          "dense_k2560": (24, 2560, D_D)}
SMEM_CAP = 232448                  # the earlier kernel staged W whole


def load_before(path: str):
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "libclustered_agg_before.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), path],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).clustered_agg_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", help="an earlier clustered_agg.cu")
    ap.add_argument("--only", nargs="*", default=list(SHAPES),
                    help="shapes to time (default all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import (K1_RTOL, PEAK_FP32_FLOPS, bound,
                            device_ms_per_launch, padded_rows, time_ms)
    from repro_torch.kernels import build
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.kernels.ref import clustered_agg_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    for line in build.build(["clustered_agg"]).get("clustered_agg",
                                                    "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"current: {line.strip()}", file=sys.stderr)
    before = load_before(args.before) if args.before else None

    def run_before(w, theta):
        S, K = w.shape
        D = theta.shape[1]
        out = torch.empty((S, D), device=theta.device)
        vec4 = int(D % 4 == 0)
        rc = before(w.data_ptr(), theta.data_ptr(), out.data_ptr(), S, K, D,
                    vec4, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"earlier kernel: CUDA error {rc}")
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for where in args.only:
        S, K, D = SHAPES[where]
        w = torch.softmax(torch.randn((S, K), generator=gen, device="cuda"),
                          1)
        theta = padded_rows(torch.randn((K, D), generator=gen,
                                        device="cuda"))
        want = clustered_agg_ref(w, theta)
        scale = max(1.0, float(want.abs().max()))
        kernels = {"current": lambda: wa.clustered_agg_flat(w, theta)}
        if before is not None and S * K * 4 <= SMEM_CAP:
            dense = theta.contiguous()
            kernels["before"] = lambda: run_before(w, dense)
        err = {}
        for name, fn in kernels.items():
            err[name] = float((fn() - want).abs().max())
            if not err[name] <= K1_RTOL * scale:
                raise AssertionError(f"{name} kernel differs from the plain "
                                     f"version at {where}: {err[name]}")
        t = {name: [] for name in kernels}
        for name in ("before", "current", "current", "before"):
            if name in kernels:
                t[name].append(device_ms_per_launch(
                    kernels[name], "clustered_agg_kernel", n=20))
        b_ms, b_by = bound(4.0 * (S * K + K * D + S * D), 2.0 * S * K * D)
        out[where] = {
            "shape": {"S": S, "K": K, "D": D}, "device_ms": t,
            "max_abs_err": err,
            "matmul_ms": time_ms(lambda: torch.matmul(w, theta), iters=20),
            "plain_ms": time_ms(lambda: clustered_agg_ref(w, theta),
                                iters=20),
            "bound_ms": b_ms, "bound_by": b_by,
            "fma_ms": 2.0 * S * K * D / PEAK_FP32_FLOPS * 1e3}
        print(f"{where}: {json.dumps(out[where])}", file=sys.stderr,
              flush=True)
        del theta, want
        torch.cuda.empty_cache()
    print(json.dumps({"k1_before_after": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
