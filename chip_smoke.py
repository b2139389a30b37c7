#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):
  1. a CUDA device must be present; prints the card's name and power
     limit as nvidia-smi reports them;
  2. builds the hand-written kernels from src/repro_torch/csrc with nvcc
     (sm_90a), one nvcc per source, all started together;
  3. the training slice: ``repro_torch.launch.train.main`` at the paper's
     full Table-3 widths, 8 clients, --epochs 6 --federate-every 2 (two
     FedAvg warm-up rounds, then clustered rounds), with the launch
     counts of K1/K2 set to 0 just before and read just after;
  4. checks the outcome: the rounds ran, every kernel launched, losses
     and parameters are finite, the generator's images have the right
     shape and range, a clustered round through the kernels equals the
     same round through their plain expressions, and a small trainer on
     the card agrees with the same trainer on the CPU;
  5. GAN split serving: ``repro_torch.launch.serve_split.main --mode gan``
     at full width on both profile mixes (24 requests each); the images
     are finite, in the tanh range and equal each client's monolithic
     eval-mode forward, and a one-group cohort drops the absent cuts;
     one served cohort per mix is profiled (device busy share);
  6. LM split serving: ``serve_split.main --mode lm`` with the launch
     counts of K3/K4 set to 0 just before and read just after (K3 once
     per block per generate call, K4 once per block per decoded token);
     the greedy tokens are the argmax of the teacher-forced decode
     logits, which match the dense monolithic forward; one generate call
     is profiled;
  7. holds K1 (clustered_agg) and K2 (kmeans_assign) against their plain
     PyTorch versions at the slice's shapes, plus ragged and tied cases,
     and K3 (mem_attention) and K4 (flash_decode) over head dims 8-256,
     GQA groups, ragged lengths and masks, K4 also at the cache lengths
     around its split boundaries and below its split count, from the
     split LM's own shapes and cache lengths up to the granite-3-2b
     attention shapes;
  8. times each kernel, its plain version and the one PyTorch call that
     computes the same function (torch.matmul for K1,
     scaled_dot_product_attention for K3/K4, for K4 at a full cache also
     without a mask), K3/K4 at the LM's shape (with the device time per
     launch from torch.profiler) and at the granite-3-2b shapes (K4 at
     batch 8 and 1), then one epoch and one clustered
     round of the slice's trainer, and profiles one epoch (device busy
     share, the kernels that take the time);
  9. prints a JSON line with the slice's times, one with the serving
     times (``serve``), one with the kernels, then the result line.

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
PEAK_TF32_FLOPS = 495e12       # H100 SXM TF32 tensor cores, dense
# kernel vs plain version: both accumulate K float32 products in
# different orders (an FMA chain vs the library's tiling), so they may
# differ by a few ulps of the sum; 1e-5 relative to the output scale
# leaves two orders of magnitude above that.
K1_RTOL = 1e-5
# K3/K4 vs plain: the JAX kernel tests' float32 tolerance (an online and a
# dense softmax sum the same terms in another order)
ATTN_TOL = 2e-5
# served images vs each client's monolithic forward: the same float32
# layers run as grouped and as single convolutions (the port's forward
# tolerance)
GAN_TOL = 1e-4
# split LM decode logits vs the dense monolithic forward (the reference's
# own engine-vs-oracle tolerance)
LM_TOL = 2e-4


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


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms_per_launch(fn, key: str, n: int = 50):
    """Device time of one launch of the kernels whose name holds ``key``,
    from torch.profiler over ``n`` calls of ``fn`` (None when the trace
    shows no such kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and key in e.key]
    count = sum(e.count for e in ev)
    return (sum(e.self_device_time_total for e in ev) / 1e3 / count
            if count else None)


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


def monolithic_image(engine, req):
    """The oracle of one request: its client's full generator (personal
    head/tail rows and the server's middle layers) run unsplit in eval
    mode."""
    import torch
    from repro_torch.models.gan import GEN_LAYER_DEFS
    from repro_torch.tree import tree_map
    g = next(gg for gg in engine.groups if req.client_id in gg.client_ids)
    row = g.client_ids.index(req.client_id)
    dev = engine.device
    x = (torch.as_tensor(req.z, device=dev)[None, None],
         torch.tensor([[req.y]], device=dev))
    with torch.no_grad():
        for l, layer in enumerate(GEN_LAYER_DEFS):
            if l < g.cut.g_h or l >= g.cut.g_t:
                p = tree_map(lambda a: a[row:row + 1],
                             engine.client_params[g.name][str(l)])
            else:
                p = tree_map(lambda a: a[None], engine.server_params[str(l)])
            x, _ = layer.apply(p, x, False)
    return x[0, 0].cpu().numpy()


def check_gan_serving(serve_main) -> dict:
    """Both profile mixes through the serving CLI at full width: images
    finite, shaped [24, 28, 28, 1] and in the tanh range, each equal to
    its client's monolithic forward, and a one-group cohort compiles a
    subprogram without the other cuts."""
    import numpy as np
    from repro_torch.launch.serve_split import ServeRequest
    out = {}
    for mix in ("edge-heavy", "balanced"):
        res = serve_main(["--mode", "gan", "--mix", mix, "--device", "cuda"])
        imgs, eng, reqs = res["images"], res["engine"], res["requests"]
        if imgs.shape != (24, 28, 28, 1) or not np.isfinite(imgs).all() \
                or np.abs(imgs).max() > 1.0:
            raise AssertionError(f"{mix}: served images {imgs.shape} are "
                                 "malformed")
        err = max(float(np.abs(imgs[i] - monolithic_image(eng, r)).max())
                  for i, r in enumerate(reqs))
        if not err <= GAN_TOL:
            raise AssertionError(f"{mix}: served images differ from the "
                                 f"monolithic forward by {err}")
        g0 = eng.groups[0]
        sub = [ServeRequest(g0.client_ids[0], reqs[0].z, 7)]
        active = eng.plan(sub)[0]
        prog = eng.program_for(active)
        if active != (g0.name,) or prog.group_names != (g0.name,) or \
                prog.server_span() != tuple(range(g0.cut.g_h, g0.cut.g_t)):
            raise AssertionError(f"{mix}: one-group cohort compiled "
                                 f"{prog.group_names} over "
                                 f"{prog.server_span()}")
        sub_err = float(np.abs(eng.serve(sub)[0]
                               - monolithic_image(eng, sub[0])).max())
        if not sub_err <= GAN_TOL:
            raise AssertionError(f"{mix}: one-group cohort differs by "
                                 f"{sub_err}")
        out[mix] = {"measured_ms": res["measured_s"] * 1e3,
                    "analytic_ms": res["analytic_s"] * 1e3,
                    "ratio": res["measured_s"] / res["analytic_s"],
                    "groups": len(eng.groups), "active_cuts": len(eng.plan(
                        reqs)[0]), "max_abs_err": max(err, sub_err),
                    "profile": device_profile(lambda: eng.serve(reqs),
                                              top_n=4)}
        log(f"GAN serving {mix}: busy share "
            f"{out[mix]['profile']['busy_share']:.3f}; measured {out[mix]['measured_ms']:.3f} ms "
            f"vs analytic {out[mix]['analytic_ms']:.3f} ms (ratio "
            f"{out[mix]['ratio']:.4f}); max |d| vs monolithic {err:.3e}")
    return out


def check_lm_serving(serve_main) -> dict:
    """The LM through the serving CLI with the K3/K4 counts set to 0
    before and read after; then the greedy tokens against the decode
    logits and those against the dense monolithic forward."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mem_attention as ma
    from repro_torch.launch.serve_split import (lm_reference_logits,
                                                split_lm_decode_logits,
                                                split_lm_generate)
    ma.launches = 0
    fd.launches = 0
    res = serve_main(["--mode", "lm", "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {"mem_attention": ma.launches, "flash_decode": fd.launches}
    cfg, calls = res["cfg"], res["generate_calls"]
    n_gen = res["tokens"].shape[1]
    want = {"mem_attention": cfg.n_layers * calls,
            "flash_decode": cfg.n_layers * (n_gen - 1) * calls}
    if counts != want:
        raise AssertionError(f"LM serving launched {counts}, expected "
                             f"{want} for {calls} generate calls")
    prompt, params = res["prompt"], res["params"]
    toks = torch.as_tensor(res["tokens"], device=prompt.device)
    full = torch.cat([prompt, toks], 1)
    P = prompt.shape[1]
    logits = split_lm_decode_logits(cfg, params, full, P)
    if not torch.equal(toks, torch.argmax(logits, -1).to(torch.int32)):
        raise AssertionError("greedy tokens are not the argmax of the "
                             "decode logits")
    dense = lm_reference_logits(cfg, params, full)[:, P - 1:-1]
    err = float((logits - dense).abs().max())
    if not bool(((logits - dense).abs() <= LM_TOL + LM_TOL * dense.abs()
                 ).all()):
        raise AssertionError(f"decode logits differ from the dense forward "
                             f"by {err}")
    prof = device_profile(lambda: split_lm_generate(cfg, params, prompt,
                                                    n_gen), top_n=4)
    log(f"LM serving: {res['tok_per_s']:.1f} tok/s, launches {counts}, "
        f"max |d logits| vs dense {err:.3e}; generate busy share "
        f"{prof['busy_share']:.3f}")
    return {"tok_per_s": res["tok_per_s"], "generate_s": res["seconds"],
            "batch": int(prompt.shape[0]), "prompt": P, "gen": n_gen,
            "launches": counts,
            "launches_per_generate": {k: v // calls
                                      for k, v in counts.items()},
            "max_abs_logit_err": err, "profile": prof}


def _valid_err(got, want, lens) -> float:
    """Max abs difference over the rows before each batch row's length."""
    return max(float((got[b, :int(n)] - want[b, :int(n)]).abs().max())
               for b, n in enumerate(lens.tolist()) if n > 0)


def check_attention(gen) -> float:
    """K3 and K4 against their plain versions; returns the worst error."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mem_attention as ma
    from repro_torch.kernels.ref import (flash_decode_ref,
                                         flash_decode_split_ref,
                                         mem_attention_ref)
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    worst = {"mem_attention": 0.0, "flash_decode": 0.0}

    def record(name, err, what):
        if not err <= ATTN_TOL:
            raise AssertionError(f"{name} disagrees at {what}: {err}")
        worst[name] = max(worst[name], err)

    # hd 8 to 256; S = 37 and 300 are not multiples of the tiles
    for S in (37, 128, 300, 4096):
        for hd in (8, 16, 64, 128, 256):
            for G in (1, 2, 4):
                KV = 2
                q, k, v = rand(2, S, KV * G, hd), rand(2, S, KV, hd), \
                    rand(2, S, KV, hd)
                lens = torch.tensor([S, S - 5], dtype=torch.int32, device=dev)
                for causal in (True, False):
                    got = ma.mem_attention(q, k, v, lens, causal)
                    want = mem_attention_ref(q, k, v, lens, causal)
                    torch.cuda.synchronize()
                    record("mem_attention", _valid_err(got, want, lens),
                           f"S={S} hd={hd} G={G} causal={causal}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for S in (64, 1000, 32768):
        for hd in (8, 16, 64, 128, 256):
            for G in (1, 2, 4):
                KV = 2
                q, k, v = rand(2, KV * G, hd), rand(2, S, KV, hd), \
                    rand(2, S, KV, hd)
                # lengths on the split boundaries and below the split
                # count; at S=64, hd=16, G=2 the cache lengths 33 and 47
                # are the split LM's first and last decode steps
                n = fd.decode_splits(2, KV, S, n_sm)
                clens = set(fd.split_boundary_lengths(S, n))
                if S == 64:
                    clens |= {33, 47}
                for clen in sorted(clens):
                    want = flash_decode_ref(q, k, v, clen)
                    for length in (clen, torch.tensor(
                            clen, dtype=torch.int32, device=dev)):
                        got = fd.flash_decode(q, k, v, length)
                        torch.cuda.synchronize()
                        record("flash_decode",
                               float((got - want).abs().max()),
                               f"S={S} hd={hd} G={G} cache_len={clen}")
                # an empty cache gives zeros, as the TPU kernel and the
                # split twin do
                zero = torch.tensor(0, dtype=torch.int32, device=dev)
                if not torch.equal(fd.flash_decode(q, k, v, zero),
                                   torch.zeros_like(q)):
                    raise AssertionError(f"K4 at cache_len 0 (S={S} hd={hd} "
                                         f"G={G}) is not zero")
                for clen in (0, 1, n - 1, S):
                    record("flash_decode", float((
                        flash_decode_split_ref(q, k, v, clen, n)
                        - (flash_decode_ref(q, k, v, clen) if clen else 0.0)
                        ).abs().max()),
                        f"split twin S={S} hd={hd} G={G} cache_len={clen}")
    # corrupting K/V at or past the length changes no valid output
    q, k, v = rand(2, 48, 4, 16), rand(2, 48, 2, 16), rand(2, 48, 2, 16)
    lens = torch.tensor([30, 17], dtype=torch.int32, device=dev)
    k2, v2 = k.clone(), v.clone()
    k2[:, 17:], v2[:, 17:] = 55.0, -55.0
    if not torch.equal(ma.mem_attention(q, k, v, lens)[1, :17],
                       ma.mem_attention(q, k2, v2, lens)[1, :17]):
        raise AssertionError("K3 reads keys past the row's length")
    if not torch.equal(fd.flash_decode(q[:, 3].contiguous(), k, v, 17),
                       fd.flash_decode(q[:, 3].contiguous(), k2, v2, 17)):
        raise AssertionError("K4 reads cache rows past cache_len")
    # the same over a cache split across blocks
    q, k, v = rand(2, 4, 16), rand(2, 4096, 2, 16), rand(2, 4096, 2, 16)
    k2, v2 = k.clone(), v.clone()
    k2[:, 1000:], v2[:, 1000:] = 55.0, -55.0
    if not torch.equal(fd.flash_decode(q, k, v, 1000),
                       fd.flash_decode(q, k2, v2, 1000)):
        raise AssertionError("K4 reads cache rows past cache_len when split")
    log(f"K3/K4 vs plain: worst max abs err {worst} (tolerance {ATTN_TOL})")
    return worst


def time_attention(gen, lm_cfg, lm_batch: int, lm_prompt: int,
                   lm_gen: int) -> dict:
    """K3 and K4 against their plain versions and one
    scaled_dot_product_attention call, at the LM's shapes and at the
    granite-3-2b attention shapes (H 32, KV 8, hd 64: K3 at B 1, S 4096,
    causal; K4 at B 8 and B 1 over 32768 cached positions). At the LM
    shapes the CUDA-event loop measures how fast the host issues calls,
    so each kernel's device time per launch is also read from
    torch.profiler. K3's bound is that of its route, 3xTF32 on the
    tensor cores (three TF32 products per product); the float32 FMA
    bound stands beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mem_attention as ma
    from repro_torch.kernels.ref import flash_decode_ref, mem_attention_ref
    dev = torch.device("cuda")

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def k3(B, S, H, KV, hd, iters):
        q, k, v = rand(B, S, H, hd), rand(B, S, KV, hd), rand(B, S, KV, hd)
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        pos = torch.arange(S, device=dev)
        mask = ((pos[None, :] <= pos[:, None])[None, None]
                & (pos[None, None, None, :] < lens[:, None, None, None]))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((lib().transpose(1, 2)
                         - mem_attention_ref(q, k, v, lens)).abs().max())
        pairs = B * S * (S + 1) / 2
        nbytes = 4.0 * (2 * B * S * H * hd + 2 * B * S * KV * hd + B)
        flops = 4.0 * hd * H * pairs
        b_ms, b_by = bound(nbytes, 3 * flops, PEAK_TF32_FLOPS)
        return {"shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                          "causal": True},
                "ms": time_ms(lambda: ma.mem_attention(q, k, v, lens),
                              iters=iters),
                "device_ms": device_ms_per_launch(
                    lambda: ma.mem_attention(q, k, v, lens),
                    "mem_attention_kernel"),
                "plain_ms": time_ms(lambda: mem_attention_ref(q, k, v, lens),
                                    iters=iters),
                "library_ms": time_ms(lib, iters=iters),
                "library_max_abs_diff": lib_err,
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_route": "3xTF32 tensor cores",
                "fma_bound_ms": bound(nbytes, flops)[0]}

    def k4(B, S, clen, H, KV, hd, iters):
        q, k, v = rand(B, H, hd), rand(B, S, KV, hd), rand(B, S, KV, hd)
        mask = (torch.arange(S, device=dev) < clen)[None, None, None, :]
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = float((lib()[:, :, 0]
                         - flash_decode_ref(q, k, v, clen)).abs().max())
        b_ms, b_by = bound(4.0 * (2 * B * H * hd + 2 * B * clen * KV * hd),
                           4.0 * B * H * clen * hd)
        out = {"shape": {"B": B, "S": S, "cache_len": clen, "H": H,
                         "KV": KV, "hd": hd},
               "splits": fd.decode_splits(B, KV, S, torch.cuda.
                                          get_device_properties(dev).
                                          multi_processor_count),
               "ms": time_ms(lambda: fd.flash_decode(q, k, v, clen),
                             iters=iters),
               "device_ms": device_ms_per_launch(
                   lambda: fd.flash_decode(q, k, v, clen),
                   "flash_decode_kernel"),
               "plain_ms": time_ms(lambda: flash_decode_ref(q, k, v, clen),
                                   iters=iters),
               "library_ms": time_ms(lib, iters=iters),
               "library_max_abs_diff": lib_err,
               "bound_ms": b_ms, "bound_by": b_by}
        if clen == S:
            # the boolean mask may send SDPA to a slower backend: the
            # same call without a mask is a second yardstick
            def lib_nomask():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      enable_gqa=True)
            out["library_nomask_ms"] = time_ms(lib_nomask, iters=iters)
            out["library_nomask_max_abs_diff"] = float(
                (lib_nomask()[:, :, 0]
                 - flash_decode_ref(q, k, v, clen)).abs().max())
        return out

    c = lm_cfg
    out = {
        "mem_attention": {
            "lm": k3(lm_batch, lm_prompt, c.n_heads, c.n_kv, c.head_dim, 100),
            "granite": k3(1, 4096, 32, 8, 64, 20)},
        "flash_decode": {
            # the last decode step's cache length
            "lm": k4(lm_batch, c.s_max, lm_prompt + lm_gen - 1, c.n_heads,
                     c.n_kv, c.head_dim, 100),
            "granite": k4(8, 32768, 32768, 32, 8, 64, 20),
            "granite_b1": k4(1, 32768, 32768, 32, 8, 64, 50)},
    }
    for name, shapes in out.items():
        for where, t in shapes.items():
            log(f"{name} {where} {t['shape']}: {t['ms']:.4f} ms (device "
                f"{t['device_ms']}), plain {t['plain_ms']:.4f}, sdpa "
                f"{t['library_ms']:.4f} (no mask "
                f"{t.get('library_nomask_ms')}), bound "
                f"{t['bound_ms']:.4f} ({t['bound_by']})")
    return out


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


def device_profile(fn, per: int = 1, top_n: int = 6) -> dict:
    """``fn`` once under torch.profiler: wall time, device busy time and
    share (kernel time over wall time), kernel launches, and the kernels
    that take the most device time; launches and times in the list are
    per ``per`` (e.g. per training step)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "busy_share": busy_us / 1e6 / wall,
            "kernels": sum(e.count for e in dev) / per,
            "top": [(e.key[:70], e.self_device_time_total / 1e3 / per,
                     e.count // per) for e in top]}


def profile_epoch(tr) -> dict:
    """One epoch's training steps under torch.profiler (kernels and the
    top list per step)."""
    import numpy as np
    steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
    prof = device_profile(lambda: tr.train_steps(steps), per=steps)
    prof["kernels_per_step"] = prof.pop("kernels")
    return {"steps": steps, **prof}


def main() -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke test runs on an NVIDIA GPU")
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.launch.serve_split import SplitLMConfig
    from repro_torch.launch.serve_split import main as serve_main
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
    gan_serve = check_gan_serving(serve_main)
    lm_serve = check_lm_serving(serve_main)
    kernels = check_kernels(tr)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    gen = torch.Generator(device="cuda").manual_seed(1)
    attn_err = check_attention(gen)
    lm_cfg = SplitLMConfig(s_max=lm_serve["prompt"] + lm_serve["gen"] + 16)
    attn_times = time_attention(gen, lm_cfg, lm_serve["batch"],
                                lm_serve["prompt"], lm_serve["gen"])
    for name, replaces in (("mem_attention",
                            "src/repro/kernels/mem_attention.py:82"),
                           ("flash_decode",
                            "src/repro/kernels/flash_decode.py:70")):
        t = attn_times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": lm_serve["launches"][name],
            "max_abs_err": attn_err[name],
            **{key: t["lm"][key] for key in ("ms", "device_ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms", "shape")},
            **{where: t[where] for where in t if where != "lm"}})
    timing = time_slice(tr)
    timing["profile"] = profile_epoch(tr)
    timing.update({"slice_s": slice_s,
                   "cuts": sorted({c.as_tuple() for c in tr.cuts}),
                   "groups": len(tr.groups), "ga_latency": tr.ga_latency,
                   "k1_D": {p.net: p.n_cols for p in tr._fed_plans.values()},
                   "rounds": [d["mode"] for d in tr.fed_log]})
    print(json.dumps({"slice": timing}), flush=True)
    print(json.dumps({"serve": {"gan": gan_serve, "lm": lm_serve}}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
