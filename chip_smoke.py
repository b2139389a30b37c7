#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. a CUDA device must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. builds the hand-written kernels from src/repro_torch/csrc with nvcc
     (sm_90a), one nvcc per source, all started together;
  3. the slice: ``repro_torch.launch.train.main`` at the paper's full
     Table-3 widths, 8 clients, --epochs 6 --federate-every 2 (two
     FedAvg warm-up rounds, then clustered rounds), with every kernel's
     launch count set to 0 just before and read just after;
  4. checks the outcome: the rounds ran, every kernel launched, losses
     and parameters are finite, the generator's images have the right
     shape and range, a clustered round through the kernels equals the
     same round through their plain expressions, and a small trainer on
     the card agrees with the same trainer on the CPU;
  5. holds K1 (clustered_agg) and K2 (kmeans_assign) against their plain
     PyTorch versions at the slice's shapes, plus ragged and tied cases;
  6. times each kernel, its plain version and, for K1, the one PyTorch
     call that computes the same function (torch.matmul), then one
     epoch and one clustered round of the slice's trainer, and profiles
     one epoch (device busy share, the kernels that take the time);
  7. prints a JSON line with the slice's times, one with the kernels,
     then the result line.

Float32 products and convolutions run in full float32 (TF32 off).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM device memory
PEAK_FP32_FLOPS = 67e12        # H100 SXM float32, outside the tensor cores
# kernel vs plain version: both accumulate K float32 products in
# different orders (an FMA chain vs the library's tiling), so they may
# differ by a few ulps of the sum; 1e-5 relative to the output scale
# leaves two orders of magnitude above that.
K1_RTOL = 1e-5


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def time_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def all_finite(tree) -> bool:
    import torch
    from repro_torch.tree import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def check_slice(tr) -> None:
    """The trained state is finite, the generator's images have the
    expected shape and range, and a clustered round through the kernels
    equals the same round through their plain expressions."""
    import torch
    from repro_torch.core.clustering import kmeans_pp_init, k_selection_bound
    from repro_torch.models.gan import Z_DIM
    from repro_torch.tree import tree_items, tree_map

    modes = [d["mode"] for d in tr.fed_log]
    if modes[:2] != ["fedavg", "fedavg"] or "clustered" not in modes[2:]:
        raise AssertionError(f"federation rounds ran as {modes}")
    for m in tr.history:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite losses {tr.history}")
    for net in ("G", "D"):
        if not all_finite(tr.state[net]):
            raise AssertionError(f"non-finite {net} parameters")

    gen = torch.Generator(device=tr.device).manual_seed(123)
    inputs = {g.name: (torch.randn((g.size, 4, Z_DIM), generator=gen,
                                   device=tr.device),
                       torch.randint(0, 10, (g.size, 4), generator=gen,
                                     device=tr.device))
              for g in tr.groups}
    with torch.no_grad():
        imgs, _, _, _ = tr._gen_apply(tr.state["G"]["client"],
                                      tr.state["G"]["server"], inputs, False)
    for g in tr.groups:
        x = imgs[g.name]
        if tuple(x.shape) != (g.size, 4, 28, 28, 1) or not bool(
                torch.isfinite(x).all()) or float(x.abs().max()) > 1.0:
            raise AssertionError(f"generator output {tuple(x.shape)} for "
                                 f"group {g.name} is malformed")

    # one clustered round from the same state and the same k-means++
    # draws, through the kernels and through the plain expressions
    acts = tr._mid_ema
    z = (acts - acts.mean(0)) / (acts.std(0, correction=0) + 1e-8)
    cgen = torch.Generator(device=tr.device).manual_seed(7)
    upper = k_selection_bound(len(tr.clients))
    centers = {k: kmeans_pp_init(z, k, cgen) for k in range(2, upper + 1)}
    saved = {net: tree_map(torch.clone, tr.state[net]["client"])
             for net in ("G", "D")}
    results = []
    for use_kernel in (True, False):
        for net in ("G", "D"):
            tr.state[net]["client"] = tree_map(torch.clone, saved[net])
        tr.cfg.use_kernel = use_kernel
        diag = tr.federate(init_centers=centers)
        results.append((diag, {net: tree_map(torch.clone,
                                             tr.state[net]["client"])
                               for net in ("G", "D")}))
    tr.cfg.use_kernel = True
    (dk, pk), (dp, pp) = results
    if not torch.equal(dk["labels"], dp["labels"]) or dk["k"] != dp["k"]:
        raise AssertionError(f"clustered round: kernel labels "
                             f"{dk['labels'].tolist()} k={dk['k']} vs plain "
                             f"{dp['labels'].tolist()} k={dp['k']}")
    worst = 0.0
    for net in ("G", "D"):
        for (_, a), (_, b) in zip(tree_items(pk[net]), tree_items(pp[net])):
            worst = max(worst, float((a - b).abs().max()))
    if worst > 1e-5:
        raise AssertionError(f"clustered round through the kernels differs "
                             f"from the plain round by {worst}")
    log(f"clustered round kernel vs plain: labels equal, max |dparam| "
        f"{worst:.3e}")


def check_cpu_agreement() -> None:
    """A small trainer on the card and on the CPU, from one initial state
    and one stream of batches: losses, parameters and the clustered
    round's labels and weights agree."""
    import numpy as np
    import torch
    from repro_torch.core.clustering import kmeans_pp_init
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.bridge import state_from_numpy, state_to_numpy
    from repro_torch.core.latency import Cut, PAPER_DEVICES
    from repro_torch.core.splitting import group_by_profile
    from repro_torch.data.partition import build_scenario
    from repro_torch.tree import tree_items

    clients = build_scenario("2dom_noniid", num_clients=4, base_size=16,
                             seed=0)
    devices = [PAPER_DEVICES[i % 2] for i in range(4)]
    cuts = [Cut(1, 3, 1, 3) if i % 2 == 0 else Cut(2, 4, 2, 4)
            for i in range(4)]
    cfg = HuSCFConfig(batch=4, steps_per_epoch=2, federate_every=10 ** 6,
                      warmup_fed_rounds=1)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(4):
        b = {"real_img": {}, "real_y": {}, "z": {}, "fake_y": {}}
        for g in group_by_profile(devices, cuts):
            k = g.size
            b["real_img"][g.name] = rng.uniform(-1, 1, (k, 4, 28, 28, 1))
            b["real_y"][g.name] = rng.integers(0, 10, (k, 4))
            b["z"][g.name] = rng.normal(0, 1, (k, 4, 100))
            b["fake_y"][g.name] = rng.integers(0, 10, (k, 4))
        batches.append(b)

    def source(device):
        it = iter(batches)

        def nxt():
            b = next(it)
            return {f: {n: torch.as_tensor(
                a, dtype=torch.float32 if a.dtype.kind == "f"
                else torch.int32, device=device) for n, a in d.items()}
                for f, d in b.items()}
        return nxt

    cpu = HuSCFTrainer(clients, devices, cuts=cuts, config=cfg,
                       device="cpu", batch_source=source("cpu"))
    gpu = HuSCFTrainer(clients, devices, cuts=cuts, config=cfg,
                       device="cuda", batch_source=source("cuda"))
    gpu.state = state_from_numpy(state_to_numpy(cpu.state), "cuda")
    # the first step's losses come from identical parameters
    first = [tr.train_steps(1) for tr in (cpu, gpu)]
    for k in first[0]:
        if not math.isclose(first[0][k], first[1][k], rel_tol=1e-4):
            raise AssertionError(f"CPU vs card first-step losses {first}")
    for tr in (cpu, gpu):
        tr.train_steps(1)
        tr.federate()
        tr.train_steps(2)
    # one EMA and one set of k-means++ draws for both clustered rounds
    gpu._mid_ema = cpu._mid_ema.to(gpu.device)
    acts = cpu._mid_ema
    z = (acts - acts.mean(0)) / (acts.std(0, correction=0) + 1e-8)
    centers = {2: kmeans_pp_init(z, 2, torch.Generator().manual_seed(5))}
    dc, dg = (tr.federate(init_centers=centers) for tr in (cpu, gpu))
    if not torch.equal(dc["labels"], dg["labels"].cpu()):
        raise AssertionError("CPU vs card cluster labels differ")
    if not torch.allclose(dc["weights"], dg["weights"].cpu(), rtol=1e-4,
                          atol=1e-5):
        raise AssertionError(f"CPU vs card federation weights "
                             f"{dc['weights']} vs {dg['weights']}")
    worst = 0.0
    for net in ("G", "D"):
        for (_, a), (_, b) in zip(tree_items(cpu.state[net]),
                                  tree_items(gpu.state[net])):
            worst = max(worst, float((a - b.cpu()).abs().max()))
    # Adam's early steps move a parameter by about lr whatever the size
    # of its gradient, so a tiny gradient whose sign differs between the
    # two devices costs up to 2 lr per step: 4 steps, with margin.
    if worst > 16 * cfg.lr:
        raise AssertionError(f"CPU vs card parameters differ by {worst}")
    log(f"small trainer CPU vs card: first losses {first}, max |dparam| "
        f"{worst:.3e}")


def check_kernels(tr):
    """K1 and K2 against their plain versions; returns the kernels line."""
    import torch
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.kernels.ref import clustered_agg_ref, kmeans_assign_ref
    from repro_torch.core.clustering import k_selection_bound
    from repro_torch.models.gan import DISC_MIDDLE_FEATURES

    dev = tr.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bound_k = k_selection_bound(len(tr.clients))
    plans = {p.net: p for p in tr._fed_plans.values()}
    K = plans["G"].n_rows
    S_cl = plans["G"].num_segments(bound_k)
    shapes = [(S_cl, K, plans["G"].n_cols), (S_cl, K, plans["D"].n_cols),
              (plans["D"].num_segments(bound_k), K, plans["D"].n_cols),
              (24, K, plans["G"].n_cols), (8, K, plans["G"].n_cols),
              (1, K, 8 * 1024 + 3), (5, 3, 10_001), (24, 8, 4 * 1024 + 2)]
    k1_err = 0.0
    for S, KK, D in shapes:
        w = torch.softmax(torch.randn((S, KK), generator=gen, device=dev), 1)
        theta = torch.randn((KK, D), generator=gen, device=dev)
        got = wa.clustered_agg_flat(w, theta)
        want = clustered_agg_ref(w, theta)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        log(f"K1 S={S} K={KK} D={D}: max abs err {err:.3e}")
        if not err <= K1_RTOL * scale:
            raise AssertionError(f"K1 disagrees at S={S} K={KK} D={D}: "
                                 f"{err} > {K1_RTOL} * {scale}")
        k1_err = max(k1_err, err)

    N, D = len(tr.clients), DISC_MIDDLE_FEATURES
    for M in range(2, bound_k + 1):
        x = torch.randn((N, D), generator=gen, device=dev)
        c = torch.randn((M, D), generator=gen, device=dev)
        got, want = km.kmeans_assign(x, c), kmeans_assign_ref(x, c)
        if not torch.equal(got, want):
            raise AssertionError(f"K2 labels differ at M={M}: "
                                 f"{got.tolist()} vs {want.tolist()}")
    base = torch.randn((3, D), generator=gen, device=dev) * 2
    c = torch.cat([base, base.flip(0)], 0)          # rows 0..2 == 5..3
    x = base + 0.01 * torch.randn((3, D), generator=gen, device=dev)
    got = km.kmeans_assign(x, c)
    if not torch.equal(got, kmeans_assign_ref(x, c)) or got.tolist() != [0, 1, 2]:
        raise AssertionError(f"K2 exact ties resolve to {got.tolist()}")
    log("K2 labels equal the plain version (M in 2..%d, exact ties)" % bound_k)

    # timing at the slice's shapes
    S, D = S_cl, plans["G"].n_cols
    w = torch.softmax(torch.randn((S, K), generator=gen, device=dev), 1)
    theta = torch.randn((K, D), generator=gen, device=dev)
    k1_ms = time_ms(lambda: wa.clustered_agg_flat(w, theta))
    k1_plain = time_ms(lambda: clustered_agg_ref(w, theta))
    k1_lib = time_ms(lambda: torch.matmul(w, theta))
    k1_bound, k1_by = bound(4.0 * (S * K + K * D + S * D), 2.0 * S * K * D)
    M = bound_k
    x = torch.randn((N, DISC_MIDDLE_FEATURES), generator=gen, device=dev)
    c = torch.randn((M, DISC_MIDDLE_FEATURES), generator=gen, device=dev)
    k2_ms = time_ms(lambda: km.kmeans_assign(x, c))
    k2_plain = time_ms(lambda: kmeans_assign_ref(x, c))
    F_ = DISC_MIDDLE_FEATURES
    k2_bound, k2_by = bound(4.0 * (N * F_ + M * F_ + N),
                            2.0 * N * M * F_ + 2.0 * M * F_)
    log(f"K1 timed at S={S} K={K} D={D}; K2 at N={N} M={M} D={F_}")
    return [
        {"name": "clustered_agg", "route": "cuda",
         "source": "src/repro_torch/csrc/clustered_agg.cu",
         "replaces": "src/repro/kernels/weighted_agg.py:69",
         "launches": None, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": k1_lib},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:31",
         "launches": None, "max_abs_err": 0.0, "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None},
    ]


def time_slice(tr) -> dict:
    """Wall time of one epoch's training steps and of one clustered
    federation round, each ending in a device synchronize."""
    import numpy as np
    import torch
    steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_steps(steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.federate()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"epoch_steps": steps, "epoch_s": t1 - t0,
            "clustered_round_s": t2 - t1}


def profile_epoch(tr) -> dict:
    """One epoch's training steps under torch.profiler: device busy
    share (kernel time over wall time), kernels per step, and the
    kernels that take the most device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_steps(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    return {"steps": steps, "wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall,
            "kernels_per_step": sum(e.count for e in dev) / steps,
            "top": [(e.key[:70], e.self_device_time_total / 1e3 / steps,
                     e.count // steps) for e in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke test runs on an NVIDIA GPU")
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.launch.train import main as train_main

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = build.build()
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{name}: {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.1f}s")

    wa.launches = 0
    km.launches = 0
    t0 = time.perf_counter()
    tr = train_main(["--arch", "huscf-gan", "--epochs", "6",
                     "--federate-every", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    counts = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
    log(f"slice ran in {slice_s:.1f}s; launches {counts}; rounds "
        f"{[d['mode'] for d in tr.fed_log]}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    check_slice(tr)
    check_cpu_agreement()
    kernels = check_kernels(tr)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    timing = time_slice(tr)
    timing["profile"] = profile_epoch(tr)
    timing.update({"slice_s": slice_s,
                   "cuts": sorted({c.as_tuple() for c in tr.cuts}),
                   "groups": len(tr.groups), "ga_latency": tr.ga_latency,
                   "k1_D": {p.net: p.n_cols for p in tr._fed_plans.values()},
                   "rounds": [d["mode"] for d in tr.fed_log]})
    print(json.dumps({"slice": timing}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
