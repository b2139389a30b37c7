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
     FedAvg warm-up rounds, then clustered rounds) --ckpt
     build/slice.ckpt, on the launcher's default fused epochs (CUDA
     graphs of the training step), with the launch counts of K1/K2 set
     to 0 just before and read just after;
  4. checks the outcome: the checkpoint loads back onto the trained
     state bit for bit, the rounds ran, every kernel launched, losses
     and parameters are finite, the generator's images have the right
     shape and range, a clustered round through the kernels equals the
     same round through their plain expressions, the legacy
     per-(layer, cluster) oracle (``fused=False``, K1's S = 1 entry
     point) agrees with the fused round, and a small trainer on the card
     agrees with the same trainer on the CPU;
  3b. the fused epoch (``check_fused_epoch``, on the slice's trainer
     after its timings): from one state and one generator state, a graph
     epoch against the step loop (``fused_epoch=False``) on the same
     trainer. The batches (copied out by a recording sampler captured in
     the graph) and the EMA after one step are bit-identical, with the
     EMA's first observation and with a later one; after an epoch the
     learnable parameters agree within 2 lr times ``adam_bound`` and the
     losses are finite and within FUSED_LOSS_RTOL; a whole fused epoch is
     dispatched under ``torch.cuda.set_sync_debug_mode("error")``; the
     same agreement holds after a federation round, after a checkpoint
     load (the loaded leaves copied into the graphs' tensors bit for bit)
     and after an ``apply_churn`` (the graphs dropped and captured
     anew). Prints capture seconds, the pool's bytes, the epoch's wall
     time in turns (graph, loop, loop, graph), and for both paths the
     profiled busy share, device kernels and host launch calls per step;
  3c. cut search and re-cut: the GA at the paper's protocol
     (``GAConfig()``: population 1000, 60 generations, patience 15, seed
     0; batch 64) on the paper's 100-client mix, on the card: no worse
     than the host oracle (``fused=False``, timed once), the warm search's
     median ms over 7 runs, one search under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host
     synchronisation), ``population_latency`` against the host float64
     model over 256 seeded individuals with and without client counts
     (1e-6 relative), and one fixed set of draws giving the same
     ``SearchOut`` on the card and on the CPU. Then ``train.main`` at full
     width with 8 clients --base-size 24 --epochs 3 --federate-every 1
     --reoptimize-every 1 (the counts of K1/K2 set to 0 just before and
     read just after), epochs until a round's search adopts nothing, and
     ``update_profile(1, degraded)`` and ``apply_churn(leave=[0],
     join=[(new client, ultrafast)])``, each followed by one epoch and
     its round: every rebuild holds the migration rules (owned layers,
     server copies and EMA rows bit for bit, means within 1e-6), zeroes
     Adam's moments and keeps the step, empties the plan cache, and the
     round after it launches K1 and K2 and fills the cache again;
  3d. the legacy executor (``run_legacy``): the slice's trainer on the
     launcher's cuts with ``HuSCFConfig(split_program=False)`` (the
     reference's hand-rolled per-group loops, ``build_net_apply_legacy``)
     on fused epochs, 6 epochs with a federation every 2, the counts of
     K1/K2 set to 0 just before and read just after (both must launch):
     its losses and parameters within 2 lr times ``adam_bound`` of the
     program executor's run from the same seed (the launcher's trainer,
     copied right after its run); one forward of each net through both
     executors bit for bit (cuDNN's deterministic algorithms, for that
     check only); a replayed legacy epoch under
     ``set_sync_debug_mode("error")``; the legacy graphs against the
     legacy step loop (``graph_vs_loop``); ``fedavg_uniform(fused=False)``
     (K1's S = 1 entry point per layer and leaf) within K1_RTOL of the
     fused FedAvg; both executors' capture seconds, epoch seconds on
     graphs and on the loop (in turns: program, legacy, legacy,
     program) and device kernels per step of a profiled graph epoch;
  3e. the no-concat server schedule (``check_no_concat``): one
     training-mode forward and backward of each net at the slice's
     groups, batch 16, with ``concat_groups=False`` through the program's
     executor and through the legacy loops, bit for bit (loss, outputs,
     middles, updated leaves, gradients; deterministic cuDNN); the
     server's BatchNorm statistics differ from the concat schedule's
     exactly where a layer has more than one active group; both
     schedules' forward and backward timed and their device kernels
     counted;
  4b. the population: ``train.main`` with --clients 512 --cohort 128
     --agg-chunk 64 --epochs 4 --federate-every 1 --base-size 24 (one
     step per epoch; two chunked cohort FedAvg rounds, then two chunked
     cohort clustered rounds), with the counts set to 0 just before and
     read just after, on fused epochs (peak device memory with the
     graphs' pool, the pool's bytes, capture seconds): K1 launched once
     per chunk tile (sum over groups
     of ceil(Kg / 64), per net per round; counted by S: 8 in the FedAvg
     rounds, 24 in the clustered ones) and K2 only on 512 rows. Then
     one more clustered round leaves non-members bit for bit and moves
     every member; from one state and one set of weights and labels the
     dense and the chunked round, each through K1 and through the plain
     product, agree within 1e-5 relative (time and peak device memory
     of each beside the plan's dense and chunked buffer bytes); a
     label-KLD round (host numpy clustering at the device round's k)
     gives finite weights that sum to 1 per (cluster, cohort); one more
     epoch and clustered round are profiled (device busy share, the
     kernels that take the time); an epoch is timed as graph, loop, loop,
     graph (the graphs dropped for the loop, whose peak above the state
     is read: the pool and the loop's working set do not fit together),
     both profiled, and the graphs are dropped before the dense rounds.
     Then 16 seeded clients leave and 16
     join on the paper's profiles (``apply_churn``: rebuild seconds, a
     warm search's ms, peak device memory above the state), and one
     epoch and one clustered chunked round launch K1 once per chunk tile
     of the new groups over a cohort of 128. Prints the ``population``
     line;
  4c. quality: ``repro_torch.launch.quality.run_scenario`` on
     ``2dom_noniid`` at the paper's Table-3 widths, 8 clients on
     ``PAPER_DEVICES[i % 7]``, base size 128, batch 16, 6 epochs with a
     federation every 2 (two FedAvg rounds, then a clustered one): first
     HuSCF-GAN with the counts of K1/K2 set to 0 just before and read
     just after (both must launch), then the five baselines; each
     scored by ``evaluate_trainer`` (accuracy, F1, FPR of a CNN trained
     on 600 generated images against real per-domain test sets; dataset
     score and FID from a per-domain CNN trained on real images), every
     metric finite. A CNN trained on the card on real gratings reaches
     accuracy > 0.6 and scores real images above noise; FedGAN, MD-GAN
     and Fed-Split-GAN train one epoch on the card and on the CPU from
     one state (parameters within 2 lr times Adam's largest steps) and
     the CNN trained on both from one ``params=`` gives logits within
     1e-4 of the largest; one FedGAN step at 8 clients is profiled
     (device busy share); paper Tables 23 and 17 through
     ``launch.ablation`` at the reference's sizes (6 clients, base size
     96, 4 epochs), every metric finite and each row logged. Prints the
     ``quality`` line;
  4d. the LM family (``run_lm``): granite-3-2b at its published config
     (40 layers, d 2048, bf16) through ``launch.train.main`` (5 steps,
     batch 16, seq 128; losses and parameters finite, peak device
     memory; one more step timed and one profiled: busy share, the
     kernels that take the time) and ``launch.serve.main`` (batch 4,
     prompt 64, gen 16; prefill and decode tok/s); the logits of 4
     decode steps against a prefill over the same tokens (5e-2 of the
     largest, bf16); the decode tail profiled (ms and launches per
     token). The timed step and every arch's decode loop run under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host
     synchronisation). Every other arch of ``list_archs()`` at full width with its
     depth cut to one super-block (granite-moe-1b-a400m and whisper-tiny
     at full depth; each cut on a ``reduced`` list): one ``launch.train``
     step at batch 2, seq 128 (command-r-plus-104b serves only: a
     full-width layer with Adam does not fit the card) and a serve at
     batch 2, prompt 32, gen 4. The split transformer
     (``core.split_transformer``) on granite-3-2b at full width, 5
     layers: 3 train steps and one federation round, then clients marked
     with constants federate without crossing clusters. Every arch's
     smoke config (float32) on the card against the CPU: forward logits,
     prefill logits and cache, 2 decode steps (1e-4 of the largest). The
     LM path runs none of K1-K4 (plain attention, as in the reference);
  4e. the example twins (``run_examples``): ``examples/torch_quickstart.py``
     (6 clients, base size 96, 4 epochs; its last round clustered, with
     K1/K2 launched), ``torch_multi_domain_comparison.py --epochs 2``,
     ``torch_serve_lm.py`` and ``torch_split_lm_training.py`` at their
     defaults, each through ``main`` on the card, timed, every returned
     number finite;
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
     K1 with theta's rows padded as the federation plan pads them and
     unpadded at odd D, at S = 1, 8, 24, 32 and 40, at K = 3000 (above
     the earlier kernel's shared-memory cap), through its S = 1 entry
     point, and at the population's chunk tiles [S, 64] @ [64, D_G],
     K2 also at N=256 M=4, N=512 M=6 (the population) and N=4096 M=6
     with exact ties and NaN centres
     (the first NaN wins), and K3 (mem_attention) and K4 (flash_decode)
     over head dims 8-256,
     GQA groups, ragged lengths and masks, K4 also at the cache lengths
     around its split boundaries and below its split count, from the
     split LM's own shapes and cache lengths up to the granite-3-2b
     attention shapes;
  8. times each kernel, its plain version and the one PyTorch call that
     computes the same function (torch.matmul for K1, at the slice's
     shape, the chunk tiles at S = 24 and S = 8 and a dense round of
     2560 clients [24, 2560] @ [2560, D_D], each with its byte bound and
     its FMA time;
     scaled_dot_product_attention for K3/K4, for K4 at a full cache also
     without a mask), with the device time per launch from
     torch.profiler; K2 at the training shape (N=8 M=4), the JAX kernel
     benchmark's (N=256 M=4) and a 4096-client population (M=6), beside
     the two calls addmm + argmin of its use_kernel=False path; K3/K4 at
     the LM's shape and at the granite-3-2b shapes (K4 at
     batch 8 and 1), then one epoch and one clustered
     round of the slice's trainer, and profiles one epoch (device busy
     share, the kernels that take the time);
  9. prints a JSON line with the slice's times (with the ``legacy`` and
     ``no_concat`` phases), the ``examples`` line, the ``population``
     line, one with the serving times (``serve``), the ``recut`` line
     (the search, the 8-client re-cut and churn, the population's churn
     and its stage-1 search seconds), the ``quality`` line (per
     algorithm: training and evaluation seconds, seconds per step,
     epochs, steps and the per-domain metrics; the cuts in
     ``reduced``), the ``lm`` line (the card's name and power limit, then
     the phase 4d numbers), one with the kernels (K1 and K2 with their
     population shapes, launches and the re-cut, quality and legacy
     runs' launches), then the result line.

Float32 products and convolutions run in full float32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
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
# the population phase: 512 clients fit the card's 80 GB with the dense
# round's [K, D] buffer beside the chunked one (PERF.md section 4)
POP_CLIENTS, POP_COHORT, POP_CHUNK = 512, 128, 64
POP_BASE_SIZE = 24              # with the launcher's batch 16: one step
POP_CHURN = 16                  # clients that leave, and that join


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


def check_legacy_oracle(tr) -> dict:
    """The legacy per-(layer, cluster) loop (``fused=False``) through
    K1's S = 1 entry point, against the fused round through K1, from the
    slice's trained state and its last clustered round's weights and
    labels: every aggregated leaf within K1_RTOL of its scale."""
    import torch
    from repro_torch.core.federation import N_LAYERS, federate_client_params
    from repro_torch.kernels import weighted_agg as wa
    diag = [d for d in tr.fed_log if d["mode"] == "clustered"][-1]
    weights = diag["weights"].cpu().numpy()
    labels = diag["labels"].cpu().numpy()
    wrapped = {g.name: {net: tr.state[net]["client"][g.name]
                        for net in ("G", "D")} for g in tr.groups}
    outs, launches, secs = {}, {}, {}
    for fused in (True, False):
        wa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[fused] = federate_client_params(
            tr.groups, wrapped, weights, labels, n_layers=N_LAYERS,
            use_kernel=True, fused=fused, plan_cache={})
        torch.cuda.synchronize()
        secs[fused] = time.perf_counter() - t0
        launches[fused] = wa.launches
    worst = max_rel_diff(outs[False], outs[True])
    if not worst <= K1_RTOL or launches[False] <= launches[True]:
        raise AssertionError(f"legacy round vs fused round: {worst} (K1 "
                             f"launches {launches})")
    log(f"legacy oracle round (fused=False, K1 S = 1) vs fused round: max "
        f"rel diff {worst:.3e}; K1 launches {launches[False]} vs "
        f"{launches[True]}; {secs[False]:.3f}s vs {secs[True]:.3f}s")
    return {"max_rel_diff": worst, "k1_launches": launches[False],
            "fused_k1_launches": launches[True], "legacy_s": secs[False],
            "fused_s": secs[True]}


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
    # a host batch source cannot be replayed: both run the step loop
    cfg = HuSCFConfig(batch=4, steps_per_epoch=2, federate_every=10 ** 6,
                      warmup_fed_rounds=1, fused_epoch=False)
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


def paper_mix(n: int = 100, seed: int = 0):
    """The paper's device mix: ``n`` clients drawn uniformly over the 7
    profiles of Table 4 from ``numpy.random.default_rng(seed)`` (the
    recipe of ``benchmarks/latency_table.py``)."""
    import numpy as np
    from repro_torch.core.latency import PAPER_DEVICES
    rng = np.random.default_rng(seed)
    return [PAPER_DEVICES[i] for i in rng.integers(0, 7, n)]


def run_search(device: str = "cuda") -> dict:
    """Phase 3c, the search: ``GAConfig()`` (population 1000, 60
    generations, patience 15, seed 0), batch 64, on the paper's
    100-client mix. The search on the card is no worse than the host
    oracle; one ``run`` under ``set_sync_debug_mode("error")`` makes no
    host synchronisation; ``population_latency`` on the card matches
    the host float64 model over 256 seeded individuals, with and
    without client counts; one fixed set of draws gives the same
    ``SearchOut`` on the card and on the CPU. Returns the ``search``
    fields of the ``recut`` line."""
    import numpy as np
    import torch
    from repro_torch.core import genetic as ga
    from repro_torch.core.latency import (PAPER_SERVER,
                                          huscf_iteration_latency)
    from repro_torch.core.latency_device import (build_latency_tables,
                                                 population_latency)
    devices = paper_mix()
    cfg = ga.GAConfig()
    t0 = time.perf_counter()
    host = ga.optimize_cuts(devices, batch=64, config=cfg, fused=False)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    searcher = ga.CutSearcher(devices, batch=64, config=cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    fused = searcher.to_result(searcher.run(gen))
    first_s = time.perf_counter() - t0
    if not fused.latency <= host.latency + 1e-9:
        raise AssertionError(f"fused search {fused.latency} is worse than "
                             f"the host oracle's {host.latency}")
    warm = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        searcher.run(gen)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    # the counterpart of the reference's transfer guard: a search that
    # synchronises with the host raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = searcher.run(gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    searcher.to_result(out)

    # the batched model against the host float64 model
    rng = np.random.default_rng(3)
    opts = searcher.options
    per_client = build_latency_tables(devices, PAPER_SERVER, 64,
                                      device=device)
    worst = {}
    for name, tables, counts, n_genes in (
            ("per_client", per_client, None, len(devices)),
            ("profile_counts", searcher.tables, searcher.counts,
             searcher.n_genes)):
        idx = rng.integers(0, len(opts), (256, n_genes))
        got = population_latency(tables, torch.as_tensor(idx, device=device),
                                 counts).cpu().numpy()
        prof = None if counts is None else searcher.profile_of
        want = np.array([huscf_iteration_latency(
            ga._upsample_cuts(ind, prof, len(devices), opts), devices,
            PAPER_SERVER, 64) for ind in idx])
        worst[name] = float(np.max(np.abs(got - want) / want))
    if not max(worst.values()) <= 1e-6:
        raise AssertionError(f"population_latency vs host model: {worst}")

    # one fixed set of draws on the card and on the CPU
    cpu = ga.CutSearcher(devices, batch=64, config=cfg, device="cpu")
    g_cpu = torch.Generator().manual_seed(1)
    n_opt = len(opts)
    init = ga.draw_initial(g_cpu, cfg, cpu.n_genes, n_opt)
    draws = [ga.draw_generation(g_cpu, cfg, cpu.n_genes, n_opt)
             for _ in range(cfg.generations)]
    on_card = [ga.Draws(*(x.to(device) for x in d)) for d in draws]
    o_cpu = cpu.run(None, init_pop=init, draws=draws.__getitem__)
    o_dev = searcher.run(None, init_pop=init.to(device),
                         draws=on_card.__getitem__)
    h_cpu, h_dev = o_cpu.history.numpy(), o_dev.history.cpu().numpy()
    same_path = (torch.equal(o_cpu.best_ind, o_dev.best_ind.cpu())
                 and int(o_cpu.convergence_gen) == int(o_dev.convergence_gen)
                 and int(o_cpu.generations_run) == int(o_dev.generations_run)
                 and np.array_equal(np.isnan(h_cpu), np.isnan(h_dev))
                 and np.allclose(h_cpu, h_dev, rtol=1e-6, equal_nan=True))
    if not same_path:
        raise AssertionError(f"fixed draws: card {o_dev} vs CPU {o_cpu}")
    bitwise = bool(np.array_equal(h_cpu, h_dev, equal_nan=True)
                   and float(o_cpu.best_latency) == float(o_dev.best_latency))
    line = {"clients": len(devices), "population": cfg.population_size,
            "generations": cfg.generations,
            "patience": cfg.early_stop_patience, "batch": 64,
            "n_genes": searcher.n_genes, "host_latency": host.latency,
            "host_s": host_s, "host_generations_run": host.generations_run,
            "fused_latency": fused.latency, "fused_first_s": first_s,
            "fused_warm_ms": float(np.median(warm)), "fused_warm_ms_all": warm,
            "generations_run": fused.generations_run,
            "convergence_gen": fused.convergence_gen,
            "cuts": sorted({c.as_tuple() for c in fused.cuts}),
            "sync_free": True, "population_latency_max_rel": worst,
            "card_vs_cpu_same_path": same_path,
            "card_vs_cpu_bitwise": bitwise}
    log(f"cut search (paper protocol, 100 clients): fused {fused.latency:.6f}"
        f" s vs host {host.latency:.6f} s; host {host_s:.2f}s, fused first "
        f"{first_s:.2f}s, warm {line['fused_warm_ms']:.2f} ms; "
        f"{fused.generations_run} generations; no host sync; latency model "
        f"{worst}; fixed draws card = CPU (bitwise {bitwise})")
    return line


def check_migration(old: dict, tr, old_of) -> dict:
    """A rebuild's state against the migration rules, from the old groups,
    state and EMA: a client's row of a layer it owned is its old row and
    of a layer the old server held the server's copy, bit for bit; any
    other row (a joiner's layer the old server never held) and a layer
    newly on the server are the mean of the old client copies (float64
    here, 1e-6 relative to the leaf's scale). EMA rows of survivors are
    theirs bit for bit, a joiner's the survivor mean. Adam's moments are
    zero and the step counter is kept. Returns the counts checked."""
    import torch
    from repro_torch.core.federation import N_LAYERS
    from repro_torch.core.splitting import client_owned_layers, layer_pair
    from repro_torch.tree import tree_items, tree_leaves
    n_copy = n_mean = 0
    worst = 0.0

    def mean_ok(got, want64):
        nonlocal n_mean, worst
        scale = max(float(want64.abs().max()), 1e-30)
        err = float((got.double() - want64).abs().max()) / scale
        worst = max(worst, err)
        n_mean += 1
        if not err <= 1e-6:
            raise AssertionError(f"migrated mean off by {err}")

    def copy_ok(got, want, what):
        nonlocal n_copy
        n_copy += 1
        if not same_bits(got, want):
            raise AssertionError(f"migrated copy differs: {what}")

    for net in ("G", "D"):
        n = N_LAYERS[net]
        owned = {g.name: set(client_owned_layers(layer_pair(g.cut, net), n))
                 for g in old["groups"]}
        loc = {cid: (g.name, pos) for g in old["groups"]
               for pos, cid in enumerate(g.client_ids)}
        o_client = old["state"][net]["client"]
        o_server = old["state"][net]["server"]

        def mean64(l):
            stacks = [dict(tree_items(o_client[g.name][str(l)]))
                      for g in old["groups"] if l in owned[g.name]]
            return {p: torch.cat([s[p] for s in stacks]).double().mean(0)
                    for p in stacks[0]}

        for g in tr.groups:
            for layer, tree in tr.state[net]["client"][g.name].items():
                l = int(layer)
                new = dict(tree_items(tree))
                for pos, cid in enumerate(g.client_ids):
                    o = old_of[cid]
                    if o >= 0 and l in owned[loc[o][0]]:
                        src = dict(tree_items(o_client[loc[o][0]][layer]))
                        for p, x in new.items():
                            copy_ok(x[pos], src[p][loc[o][1]],
                                    f"{net} {g.name} layer {l} client {cid}")
                    elif layer in o_server:
                        src = dict(tree_items(o_server[layer]))
                        for p, x in new.items():
                            copy_ok(x[pos], src[p],
                                    f"{net} {g.name} layer {l} client {cid} "
                                    "(server copy)")
                    else:
                        want = mean64(l)
                        for p, x in new.items():
                            mean_ok(x[pos], want[p])
        for layer, tree in tr.state[net]["server"].items():
            new = dict(tree_items(tree))
            if layer in o_server:
                src = dict(tree_items(o_server[layer]))
                for p, x in new.items():
                    copy_ok(x, src[p], f"{net} server layer {layer}")
            else:
                want = mean64(int(layer))
                for p, x in new.items():
                    mean_ok(x, want[p])
    surv = [(i, o) for i, o in enumerate(old_of) if o >= 0]
    for i, o in surv:
        copy_ok(tr._mid_ema[i], old["ema"][o], f"EMA row {i}")
    fill = old["ema"][[o for _, o in surv]].double().mean(0)
    for i, o in enumerate(old_of):
        if o < 0:
            mean_ok(tr._mid_ema[i], fill)
    for opt in ("opt_g", "opt_d"):
        st = tr.state[opt]
        if st.step != 0 or any(bool(x.any()) for x in
                               tree_leaves(st.mu) + tree_leaves(st.nu)):
            raise AssertionError(f"{opt} was not re-initialised")
    if tr.state["step"] != old["step"]:
        raise AssertionError(f"step {tr.state['step']} != {old['step']}")
    return {"copies": n_copy, "means": n_mean, "max_mean_rel": worst}


def run_recut(train_main, device: str = "cuda") -> dict:
    """Phase 3c, re-cut and churn at full width: ``train.main`` with 8
    clients, --reoptimize-every 1 (the counts of K1/K2 set to 0 just
    before and read just after), epochs until a round's search adopts
    nothing; then a degraded profile for client 1 and a churn (client 0
    leaves, a client on an unseen fast profile joins), each followed by
    one epoch and its round. Each rebuild is held to the migration rules
    (``check_migration``), empties the plan cache, and the round after
    it launches K1 and K2 and fills the cache again. Returns the
    ``slice`` fields of the ``recut`` line."""
    import torch
    from repro_torch.core.latency import DeviceProfile
    from repro_torch.data.partition import build_scenario
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    wa.launches = 0
    km.launches = 0
    t0 = time.perf_counter()
    tr = train_main(["--arch", "huscf-gan", "--clients", "8", "--base-size",
                     "24", "--epochs", "3", "--federate-every", "1",
                     "--reoptimize-every", "1", "--device", device])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "re-cut run")
    settle = 0
    while tr.fed_log[-1]["recut"] and settle < 5:
        tr.train_epoch()
        settle += 1
    recuts = [d["recut"] for d in tr.fed_log]
    if recuts[-1] is not False:
        raise AssertionError(f"the per-round search never settled: {recuts}")
    log(f"re-cut run ({run_s:.1f}s, GA {tr.ga_seconds:.2f}s): recut per "
        f"round {recuts}; launches {launches}")

    slow = DeviceProfile("degraded", 0.25e9, 4.0, 1.2e6)
    fast = DeviceProfile("ultrafast", 3.0e9, 64.0, 500e6)
    joiner = build_scenario("2dom_noniid", num_clients=8, base_size=24,
                            seed=1)[0]
    events = {}
    for name in ("update_profile", "churn"):
        old = {"groups": list(tr.groups), "ema": tr._mid_ema,
               "step": tr.state["step"],
               "state": {net: tr.state[net] for net in ("G", "D")}}
        old_of = (list(range(len(tr.clients))) if name == "update_profile"
                  else tr.registry.churn([0], [joiner.n])[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "update_profile":
            tr.update_profile(1, slow)
        else:
            tr.apply_churn(leave=[0], join=[(joiner, fast)])
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        if tr._fed_plans:
            raise AssertionError(f"{name}: the plan cache survived the "
                                 "rebuild")
        checked = check_migration(old, tr, old_of)
        del old
        wa.launches = 0
        km.launches = 0
        tr.train_epoch()
        torch.cuda.synchronize()
        after = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
        diag = tr.fed_log[-1]
        if min(after.values()) <= 0 or not tr._fed_plans or \
                diag["mode"] != "clustered":
            raise AssertionError(f"{name}: the round after the rebuild "
                                 f"launched {after}, mode {diag['mode']}, "
                                 f"{len(tr._fed_plans)} plans")
        for net in ("G", "D"):
            if not all_finite(tr.state[net]):
                raise AssertionError(f"{name}: non-finite {net} state")
        events[name] = {"rebuild_s": rebuild_s, "migration": checked,
                        "groups": [g.name for g in tr.groups],
                        "launches_after": after,
                        "recut_after": diag.get("recut")}
        log(f"{name}: rebuild {rebuild_s:.3f}s, migration {checked}, "
            f"groups {events[name]['groups']}, round after: {after}")
    if len(tr.clients) != 8 or tr.devices[-1] is not fast:
        raise AssertionError("the churn did not swap client 0 for the "
                             "joiner")
    return {"clients": 8, "run_s": run_s, "ga_s": tr.ga_seconds,
            "recut_per_round": recuts, "settle_epochs": settle,
            "launches": launches, "events": events}


def check_kernels(tr):
    """K1 and K2 against their plain versions; returns the kernels line."""
    import torch
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.kernels.ref import (clustered_agg_ref, kmeans_assign_ref,
                                         weighted_agg_ref)
    from repro_torch.core.clustering import k_selection_bound
    from repro_torch.models.gan import DISC_MIDDLE_FEATURES

    dev = tr.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bound_k = k_selection_bound(len(tr.clients))
    plans = {p.net: p for p in tr._fed_plans.values()}
    K = plans["G"].n_rows
    S_cl = plans["G"].num_segments(bound_k)
    D_G, D_D = plans["G"].n_cols, plans["D"].n_cols
    # (S, K, D, layout): the slice's rounds as the plan lays theta out
    # (rows padded to 32 floats); odd D unpadded (4-byte copies); every
    # row template (S = 1; 8; 24 in two groups of 12; 32 and 40 in
    # groups of 16; 130 in two blocks of rows) on both layouts; K = 3000
    # clients, far above the 227 KB of W the earlier kernel held in one
    # block's shared memory
    shapes = [(S_cl, K, D_G, "padded"), (S_cl, K, D_D, "padded"),
              (plans["D"].num_segments(bound_k), K, D_D, "padded"),
              (S_cl, K, D_G, "contiguous"), (24, K, D_G, "contiguous"),
              (8, K, D_G, "contiguous"), (1, K, 8 * 1024 + 3, "contiguous"),
              (5, 3, 10_001, "contiguous"), (24, 8, 4 * 1024 + 2, "contiguous")]
    shapes += [(S, 13, D, layout) for S in (1, 8, 24, 32, 40, 130)
               for D, layout in ((D_D, "padded"), (10_001, "contiguous"))]
    shapes += [(24, 3000, 65_537, "padded"), (24, 3000, 65_537, "contiguous")]
    k1_err = 0.0
    for S, KK, D, layout in shapes:
        w = torch.softmax(torch.randn((S, KK), generator=gen, device=dev), 1)
        theta = torch.randn((KK, D), generator=gen, device=dev)
        if layout == "padded":
            theta = padded_rows(theta)
        got = wa.clustered_agg_flat(w, theta)
        want = clustered_agg_ref(w, theta)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        log(f"K1 S={S} K={KK} D={D} {layout}: max abs err {err:.3e}")
        if not err <= K1_RTOL * scale:
            raise AssertionError(f"K1 disagrees at S={S} K={KK} D={D} "
                                 f"{layout}: {err} > {K1_RTOL} * {scale}")
        k1_err = max(k1_err, err)
    # the S = 1 entry point: one weighted average over the slice's clients
    x = torch.randn((K, D_G), generator=gen, device=dev)
    wk = torch.softmax(torch.randn((K,), generator=gen, device=dev), 0)
    got, want = wa.weighted_agg_flat(x, wk), weighted_agg_ref(x, wk)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"K1 weighted_agg_flat K={K} D={D_G}: max abs err {err:.3e}")
    if not err <= K1_RTOL * max(1.0, float(want.abs().max())):
        raise AssertionError(f"weighted_agg_flat disagrees: {err}")
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
    # the training path's shape, the JAX package's kernel-benchmark shape
    # (benchmarks/kernel_bench.py) and a population of 4096 clients at
    # k_max = 6 centres, where x (103 MB) exceeds the L2 cache
    k2_shapes = {"train": (N, bound_k, D), "kernel_bench_256": (256, 4, D),
                 "population_4096": (4096, 6, D)}
    for where, (NN, M, DD) in k2_shapes.items():
        check_kmeans_assign(gen, NN, M, DD, where)

    # timing at the slice's shapes, theta laid out as the plan lays it,
    # and at S = 1 (a weighted average of the slice's clients, the legacy
    # oracle's shape of call)
    k1 = time_clustered_agg(gen, S_cl, K, D_G)
    k1["s1"] = time_clustered_agg(gen, 1, K, D_G)
    k2 = {where: time_kmeans_assign(gen, *shape)
          for where, shape in k2_shapes.items()}
    return [
        {"name": "clustered_agg", "route": "cuda",
         "source": "src/repro_torch/csrc/clustered_agg.cu",
         "replaces": "src/repro/kernels/weighted_agg.py:69",
         "launches": None, **k1, "max_abs_err": k1_err},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:31",
         "launches": None, "max_abs_err": 0.0,
         **{key: k2["train"][key] for key in (
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape")},
         **k2},
    ]


def padded_rows(theta):
    """theta [K, D] copied into rows padded as ``FederationPlan`` pads
    its flat buffers; returns the [K, D] view."""
    from repro_torch.core import federation
    return federation.padded_rows(*theta.shape, theta.device).copy_(theta)


def time_clustered_agg(gen, S: int, K: int, D: int, iters: int = 100
                       ) -> dict:
    """K1 at W [S, K] @ theta [K, D] (theta rows padded as the plan pads
    them), checked against its plain version, then timed beside it and
    torch.matmul: the CUDA-event loop, the device time per launch from
    torch.profiler, the byte bound and the time of its float32 FMAs at
    the card's peak rate."""
    import torch
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.kernels.ref import clustered_agg_ref
    dev = torch.device("cuda")
    w = torch.softmax(torch.randn((S, K), generator=gen, device=dev), 1)
    theta = padded_rows(torch.randn((K, D), generator=gen, device=dev))
    got, want = wa.clustered_agg_flat(w, theta), clustered_agg_ref(w, theta)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= K1_RTOL * max(1.0, float(want.abs().max())):
        raise AssertionError(f"K1 disagrees at S={S} K={K} D={D}: {err}")
    del got, want
    flops = 2.0 * S * K * D
    b_ms, b_by = bound(4.0 * (S * K + K * D + S * D), flops)
    out = {"shape": {"S": S, "K": K, "D": D}, "max_abs_err": err,
           "ms": time_ms(lambda: wa.clustered_agg_flat(w, theta),
                         iters=iters),
           "device_ms": device_ms_per_launch(
               lambda: wa.clustered_agg_flat(w, theta),
               "clustered_agg_kernel", n=min(50, iters)),
           "plain_ms": time_ms(lambda: clustered_agg_ref(w, theta),
                               iters=iters),
           "library_ms": time_ms(lambda: torch.matmul(w, theta),
                                 iters=iters),
           "bound_ms": b_ms, "bound_by": b_by,
           "fma_ms": flops / PEAK_FP32_FLOPS * 1e3}
    log(f"K1 timed at S={S} K={K} D={D}: {out['ms']:.4f} ms (device "
        f"{out['device_ms']}), plain {out['plain_ms']:.4f}, matmul "
        f"{out['library_ms']:.4f}, bound {b_ms:.4f} ({b_by}), FMA "
        f"{out['fma_ms']:.4f}; err {err:.2e}")
    return out


def check_kmeans_assign(gen, N: int, M: int, D: int, where: str) -> None:
    """K2 against its plain version at x [N, D] and M centres: random
    centres, exact duplicate centres (ties go to the lowest index) and
    centres holding a NaN (the first NaN wins, as jnp.argmin takes it)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels.ref import kmeans_assign_ref
    dev = torch.device("cuda")
    # small integers: every product and sum is exact in float32, so the
    # labels (exact ties included) cannot depend on summation order
    x = torch.randint(-4, 5, (N, D), generator=gen, device=dev).float()
    c = torch.randint(-4, 5, (M, D), generator=gen, device=dev).float()
    cases = [("random", x, c, None)]
    # rows 0..h-1 of the centres repeat as rows M-1..M-h; each row of x
    # lies next to one of the first h
    h = M // 2
    base = torch.randn((h, D), generator=gen, device=dev) * 2
    ct = torch.cat([base, c[h:M - h], base.flip(0)], 0)
    xt = base[torch.arange(N, device=dev) % h] + 0.01 * torch.randn(
        (N, D), generator=gen, device=dev)
    cases.append(("ties", xt, ct, torch.arange(N, device=dev) % h))
    for m in sorted({0, M // 2, M - 1}):
        cn = c.clone()
        cn[m:, 17] = float("nan")       # centres m..M-1 hold a NaN
        cases.append((f"nan_from_{m}", x, cn,
                      torch.full((N,), m, device=dev)))
    for name, xx, cc, expect in cases:
        got, want = km.kmeans_assign(xx, cc), kmeans_assign_ref(xx, cc)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"K2 {where} {name}: {bad} of {N} labels "
                                 "differ from the plain version")
        if expect is not None and not torch.equal(got.long(), expect):
            raise AssertionError(f"K2 {where} {name}: labels are not the "
                                 "lowest tied index or the first NaN")
    if any(int(t.abs().sum()) for t, _ in build.scratch.values()):
        raise AssertionError("K2 left a ticket counter above 0")
    log(f"K2 {where} N={N} M={M} D={D}: labels equal the plain version "
        "(random, exact ties, NaN centres)")


def time_kmeans_assign(gen, N: int, M: int, D: int) -> dict:
    """K2's times at x [N, D], M centres: the CUDA-event loop, the device
    time per launch from torch.profiler, the plain version and, as a
    yardstick of two calls (not one library call), the scores and argmin
    of the port's use_kernel=False path, with |c|^2 computed beforehand."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels.ref import kmeans_assign_ref
    dev = torch.device("cuda")
    x = torch.randn((N, D), generator=gen, device=dev)
    c = torch.randn((M, D), generator=gen, device=dev)
    cc = (c * c).sum(-1)
    n, _ = km.assign_splits(N, D, build.sm_count(0))
    b_ms, b_by = bound(4.0 * (N * D + M * D + N), 2.0 * N * M * D + 2.0 * M * D)
    out = {"shape": {"N": N, "M": M, "D": D}, "splits": n,
           "ms": time_ms(lambda: km.kmeans_assign(x, c)),
           "device_ms": device_ms_per_launch(
               lambda: km.kmeans_assign(x, c), "kmeans_assign_kernel"),
           "plain_ms": time_ms(lambda: kmeans_assign_ref(x, c)),
           "addmm_argmin_ms": time_ms(
               lambda: torch.argmin(torch.addmm(cc, x, c.T, alpha=-2), 1)),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    log(f"K2 timed at N={N} M={M} D={D} ({n} splits): {out['ms']:.4f} ms "
        f"(device {out['device_ms']}), plain {out['plain_ms']:.4f}, addmm + "
        f"argmin {out['addmm_argmin_ms']:.4f}, bound {b_ms:.5f} ({b_by})")
    return out


def same_bits(a, b) -> bool:
    """Two state leaves hold the same bits (tensors) or values (ints, or
    an int and a 0-dim integer tensor: Adam's step)."""
    import torch
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        return int(a) == int(b)
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def check_checkpoint(tr, path: str) -> int:
    """The launcher's checkpoint loads back onto a template of the
    trained state (the reference's layouts) and, converted back, equals
    that state bit for bit; returns the number of leaves."""
    from repro_torch.bridge import state_from_numpy, state_to_numpy
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.checkpoint.ckpt import tree_flatten
    back, step = load_checkpoint(path, state_to_numpy(tr.state))
    if step != tr.epoch:
        raise AssertionError(f"checkpoint step {step} != epoch {tr.epoch}")
    got = tree_flatten(state_from_numpy(back, tr.device))[0]
    want = tree_flatten(tr.state)[0]
    if len(got) != len(want) or not all(map(same_bits, got, want)):
        raise AssertionError("the checkpoint does not load back bit for bit")
    log(f"checkpoint {path}: {len(want)} leaves load back bit for bit")
    return len(want)


def k1_tiles(groups, chunk: int) -> int:
    """K1 launches of one chunked round of one net: one per chunk tile,
    ceil(Kg / chunk) per profile group."""
    return sum(-(-g.size // chunk) for g in groups if g.size)


def max_rel_diff(a_tree, b_tree) -> float:
    """Largest |a - b| over two client-param trees, relative to each
    leaf's scale (at least 1)."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        scale = max(1.0, float(b.abs().max()))
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def run_population(train_main, device: str = "cuda") -> dict:
    """The population phase (docstring, 4b); returns the population
    line's fields."""
    import numpy as np
    import torch
    from repro_torch.core import kld
    from repro_torch.core.clustering import (cluster_activations,
                                             k_selection_bound)
    from repro_torch.core.federation import (N_LAYERS,
                                             federate_client_params_device)
    from repro_torch.core.huscf import _carry_items
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import ops
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    # record the rows of every K2 call and the S of every K1 call the
    # trainer makes
    k2_rows, k1_s = [], []
    assign, agg = ops.kmeans_assign, ops.clustered_agg

    def recording_assign(x, centers):
        k2_rows.append((int(x.shape[0]), int(centers.shape[0])))
        return assign(x, centers)

    def recording_agg(weights, stacked):
        k1_s.append(int(weights.shape[0]))
        return agg(weights, stacked)

    ops.kmeans_assign, ops.clustered_agg = recording_assign, recording_agg
    torch.cuda.reset_peak_memory_stats()
    wa.launches = 0
    km.launches = 0
    try:
        t0 = time.perf_counter()
        tr = train_main(["--arch", "huscf-gan", "--clients",
                         str(POP_CLIENTS), "--cohort", str(POP_COHORT),
                         "--agg-chunk", str(POP_CHUNK), "--epochs", "4",
                         "--federate-every", "1", "--base-size",
                         str(POP_BASE_SIZE), "--device", device])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        ops.kmeans_assign, ops.clustered_agg = assign, agg
    counts = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
    # the launcher's fused epochs: peak device memory with the graphs'
    # pool, beside the pool's own bytes
    memory = {"peak_allocated_bytes": torch.cuda.max_memory_allocated(),
              "reserved_bytes": torch.cuda.memory_reserved(),
              "graph_pool_bytes": tr._graph_pool.pool_bytes,
              "capture_s": tr._graph_pool.capture_s,
              "state_bytes": sum(x.numel() * x.element_size()
                                 for _, x in _carry_items(tr.state))}
    log(f"population memory (fused epochs): {memory}")
    k1_by_s = {str(S): k1_s.count(S) for S in sorted(set(k1_s))}
    modes = [d["mode"] for d in tr.fed_log]
    tiles = k1_tiles(tr.groups, POP_CHUNK)
    want_k1 = 2 * tiles * len(modes)
    log(f"population ran in {run_s:.1f}s (GA {tr.ga_seconds:.1f}s); rounds "
        f"{modes}; launches {counts}; K1 reckoned {want_k1}, by S "
        f"{k1_by_s}; K2 rows {sorted(set(k2_rows))}")
    if modes != ["fedavg", "fedavg", "clustered", "clustered"]:
        raise AssertionError(f"population rounds ran as {modes}")
    if counts["clustered_agg"] != want_k1 or len(k1_s) != want_k1:
        raise AssertionError(f"K1 launched {counts['clustered_agg']} times, "
                             f"reckoned {want_k1} ({tiles} tiles per net "
                             f"per round)")
    if not k2_rows or len(k2_rows) != counts["kmeans_assign"] or any(
            n != POP_CLIENTS for n, _ in k2_rows):
        raise AssertionError(f"K2 ran {counts['kmeans_assign']} times on "
                             f"rows {sorted(set(k2_rows))}, not only on "
                             f"{POP_CLIENTS}")
    for d in tr.fed_log:
        if len(d["cohort"]) != POP_COHORT:
            raise AssertionError(f"round {d['round']} cohort of "
                                 f"{len(d['cohort'])}")
    for net in ("G", "D"):
        if not all_finite(tr.state[net]):
            raise AssertionError(f"non-finite {net} parameters")

    bound_k = k_selection_bound(POP_CLIENTS)
    # one epoch (one step) and one more clustered round, timed; the round
    # leaves every non-member's copies bit for bit and moves every member
    steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
    epoch_s = {"graph": [], "loop": []}

    def timed_epoch(fused: bool) -> None:
        tr.cfg.fused_epoch = fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_steps(steps)
        torch.cuda.synchronize()
        epoch_s["graph" if fused else "loop"].append(
            time.perf_counter() - t0)
        tr.cfg.fused_epoch = True

    # graph, loop, loop, graph; the graphs' pool and the step loop's own
    # working set do not fit the card together at this scale, so the
    # graphs are dropped for the loop (and its peak above the state is
    # read) and captured again after it
    timed_epoch(True)
    tr._drop_graphs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    timed_epoch(False)
    memory["loop_epoch_peak_above_bytes"] = (
        torch.cuda.max_memory_allocated() - base)
    timed_epoch(False)
    tr.cfg.fused_epoch = False
    prof_loop = device_profile(lambda: tr.train_steps(steps), per=steps)
    tr.cfg.fused_epoch = True
    torch.cuda.empty_cache()
    warm_graphs(tr, steps)
    memory["recapture_s"] = tr._graph_pool.capture_s
    timed_epoch(True)
    prof_epoch = device_profile(lambda: tr.train_steps(steps), per=steps)
    log(f"population epochs (s): {epoch_s}; loop epoch peak above the "
        f"state and carry {memory['loop_epoch_peak_above_bytes']}")
    # the pool stays reserved between epochs; the dense rounds compared
    # below need its room, so the graphs go (the churn captures anew)
    tr._drop_graphs()
    torch.cuda.empty_cache()
    before = {net: tree_map(torch.clone, tr.state[net]["client"])
              for net in ("G", "D")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = tr.federate()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    member = torch.zeros(POP_CLIENTS, dtype=torch.bool, device=tr.device)
    member[diag["cohort"].long()] = True
    moved = torch.zeros(POP_CLIENTS, dtype=torch.bool, device=tr.device)
    for net in ("G", "D"):
        for g in tr.groups:
            rows = torch.as_tensor(g.client_ids, device=tr.device)
            for layer, tree in before[net][g.name].items():
                new = dict(tree_items(tr.state[net]["client"][g.name][layer]))
                for path, old in tree_items(tree):
                    same = (old.view(torch.int32) == new[path].view(
                        torch.int32)).reshape(g.size, -1).all(1)
                    if bool((~same & ~member[rows]).any()):
                        raise AssertionError(f"a non-member's {net} layer "
                                             f"{layer} changed in the round")
                    moved[rows] |= ~same
    del before
    # a member alone in its (cluster, cohort) may get itself back exactly
    lab = diag["labels"].long()
    shared = torch.bincount(lab[member], minlength=bound_k)[lab] >= 2
    if not bool(moved[member & shared].all()):
        raise AssertionError(f"{int((member & shared & ~moved).sum())} "
                             "cohort members kept every parameter through "
                             "the round")
    log(f"population clustered round ({round_s:.3f}s, k={diag['k']}): "
        f"{POP_CLIENTS - POP_COHORT} non-members bit for bit, "
        f"{POP_COHORT} members moved")

    # dense and chunked rounds, through K1 and the plain product, from one
    # state, one set of weights and labels and one cohort
    acts = tr._mid_ema
    bound = bound_k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, _, _ = cluster_activations(
        acts, use_kernel=True,
        gen=torch.Generator(device=tr.device).manual_seed(11))
    torch.cuda.synchronize()
    cluster_s = time.perf_counter() - t0
    mask = tr.registry.cohort_mask(tr.registry.sample_cohort(
        torch.Generator(device=tr.device).manual_seed(12), POP_COHORT))
    weights, _ = kld.activation_weights(acts, tr._sizes_dev, labels, bound,
                                        tr.cfg.beta, cohort_mask=mask)
    plans = {}
    rounds = {}
    worst = {"dense_vs_chunked": 0.0, "kernel_vs_plain": 0.0}
    for net in ("G", "D"):
        wrapped = {g.name: {net: tr.state[net]["client"][g.name]}
                   for g in tr.groups}
        outs = {}
        for chunk in (None, POP_CHUNK):
            for use_kernel in (True, False):
                cache = {}
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                wa.launches = 0
                t0 = time.perf_counter()
                out = federate_client_params_device(
                    tr.groups, wrapped, weights, labels, bound,
                    n_layers={net: N_LAYERS[net]}, use_kernel=use_kernel,
                    plan_cache=cache, chunk_size=chunk, cohort_mask=mask,
                    cohort_size=POP_COHORT)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() - base
                tree = {g.name: out[g.name][net] for g in tr.groups}
                outs[(chunk, use_kernel)] = tree
                plan = plans[(net, chunk)] = next(iter(cache.values()))
                want = (1 if chunk is None else tiles) if use_kernel else 0
                if wa.launches != want:
                    raise AssertionError(f"{net} round chunk={chunk} "
                                         f"launched K1 {wa.launches} times, "
                                         f"not {want}")
                rounds.setdefault(net, {})[
                    f"{'chunked' if chunk else 'dense'}"
                    f"{'' if use_kernel else '_plain'}"] = {
                    "s": dt, "peak_bytes": peak,
                    "out_bytes": 4 * sum(x.numel() for x in
                                         tree_leaves(tree)),
                    "k1_launches": wa.launches}
        rounds[net]["dense_buffer_bytes"] = plans[(net, None)] \
            .dense_buffer_bytes()
        rounds[net]["chunked_buffer_bytes"] = plans[(net, POP_CHUNK)] \
            .chunked_buffer_bytes(bound)
        d = max_rel_diff(outs[(POP_CHUNK, True)], outs[(None, True)])
        p = max(max_rel_diff(outs[(c, True)], outs[(c, False)])
                for c in (None, POP_CHUNK))
        worst["dense_vs_chunked"] = max(worst["dense_vs_chunked"], d)
        worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], p)
        del outs, wrapped
        log(f"population {net} rounds: {rounds[net]}")
    if not max(worst.values()) <= K1_RTOL:
        raise AssertionError(f"population rounds disagree: {worst} > "
                             f"{K1_RTOL}")
    log(f"population dense vs chunked, kernel vs plain: {worst}")

    # the label-KLD round takes the host numpy path; its silhouette over
    # all candidate k holds an [N, N, D] array per candidate on the host,
    # so it runs at the k the device round selected
    tr.cfg.num_clusters = max(1, int(diag["k"]))
    t0 = time.perf_counter()
    lk = tr.federate(use_label_kld=True)
    torch.cuda.synchronize()
    lk_s = time.perf_counter() - t0
    tr.cfg.num_clusters = None
    w, lab = lk["weights"], lk["labels"]
    cohort = np.zeros(POP_CLIENTS, bool)
    cohort[lk["cohort"].cpu().numpy()] = True
    sums = {int(c): float(w[(lab == c) & cohort].sum())
            for c in np.unique(lab[cohort])}
    if not np.isfinite(w).all() or np.abs(w[~cohort]).max() != 0.0 or any(
            abs(v - 1.0) > 1e-9 for v in sums.values()):
        raise AssertionError(f"label-KLD weights: per (cluster, cohort) sums "
                             f"{sums}")
    log(f"population label-KLD round ({lk_s:.1f}s, k={lk['k']}): weights "
        f"sum to 1 per (cluster, cohort): {sums}")
    # where a clustered round spends its time
    prof_round = device_profile(tr.federate)
    log(f"population profiles: epoch busy share "
        f"{prof_epoch.get('busy_share')}, round busy share "
        f"{prof_round.get('busy_share')}")
    churn = run_population_churn(tr, steps)
    line = {"clients": POP_CLIENTS, "cohort": POP_COHORT, "chunk": POP_CHUNK,
            "groups": len(tr.groups), "group_sizes": [g.size
                                                      for g in tr.groups],
            "cuts": sorted({c.as_tuple() for c in tr.cuts}),
            "ga_s": tr.ga_seconds, "ga_latency": tr.ga_latency,
            "run_s": run_s, "rounds": modes, "epoch_steps": steps,
            "epoch_s": epoch_s, "clustered_round_s": round_s,
            "clustered_k": diag["k"],
            "k1_launches": counts["clustered_agg"],
            "k1_launches_per_round": 2 * tiles,
            "k1_launches_by_S": k1_by_s,
            "k2_launches": counts["kmeans_assign"],
            "k2_N": sorted({n for n, _ in k2_rows}),
            "k2_M": sorted({m for _, m in k2_rows}),
            "round_bound_k": bound, "rounds_by_net": rounds,
            "max_rel_diff": worst, "cluster_s": cluster_s,
            "label_kld_s": lk_s, "profile_epoch": prof_epoch,
            "profile_epoch_loop": prof_loop, "memory": memory,
            "profile_round": prof_round,
            "label_kld_k": lk["k"],
            "k1_D": {net: plans[(net, None)].n_cols for net in ("G", "D")},
            "S": plans[("G", None)].num_segments(bound), "churn": churn}
    del tr
    torch.cuda.empty_cache()
    return line


def run_population_churn(tr, steps: int) -> dict:
    """The population's churn: POP_CHURN seeded clients leave and as many
    new clients join on the paper's profiles (the cuts re-derived by a
    search on the card), then one epoch and one clustered chunked round,
    with the counts set to 0 just before the round and read just after:
    K1 once per chunk tile of the new groups, the cohort as configured.
    Times the rebuild, a warm search over the new population, and the
    peak device memory above the state during the rebuild."""
    import numpy as np
    import torch
    from repro_torch.core.latency import PAPER_DEVICES
    from repro_torch.data.partition import build_scenario
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    rng = np.random.default_rng(POP_CLIENTS)
    leave = sorted(int(c) for c in rng.choice(POP_CLIENTS, POP_CHURN,
                                              replace=False))
    joiners = build_scenario("2dom_noniid", num_clients=POP_CHURN,
                             base_size=POP_BASE_SIZE, seed=1)
    join = [(c, PAPER_DEVICES[i % 7]) for i, c in enumerate(joiners)]
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.apply_churn(leave=leave, join=join)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - state_bytes
    if tr.registry.n_clients != POP_CLIENTS or tr._fed_plans:
        raise AssertionError(f"churn left {tr.registry.n_clients} clients "
                             f"and {len(tr._fed_plans)} plans")
    searcher = tr._get_searcher()
    gen = torch.Generator(device=tr.device).manual_seed(5)
    searcher.run(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    searcher.run(gen)
    torch.cuda.synchronize()
    search_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tr.train_steps(steps)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    wa.launches = 0
    km.launches = 0
    t0 = time.perf_counter()
    diag = tr.federate()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
    tiles = k1_tiles(tr.groups, POP_CHUNK)
    if diag["mode"] != "clustered" or launches["clustered_agg"] != 2 * tiles \
            or launches["kmeans_assign"] <= 0:
        raise AssertionError(f"round after churn ({diag['mode']}): launches "
                             f"{launches}, K1 reckoned {2 * tiles}")
    if len(diag["cohort"]) != POP_COHORT:
        raise AssertionError(f"cohort of {len(diag['cohort'])} after churn")
    for net in ("G", "D"):
        if not all_finite(tr.state[net]):
            raise AssertionError(f"non-finite {net} state after churn")
    line = {"leave": POP_CHURN, "join": POP_CHURN, "rebuild_s": rebuild_s,
            "search_ms": search_ms, "state_bytes": state_bytes,
            "rebuild_peak_bytes_above_state": peak,
            "groups": len(tr.groups), "group_sizes": [g.size
                                                      for g in tr.groups],
            "cuts": sorted({c.as_tuple() for c in tr.cuts}),
            "epoch_s": epoch_s, "round_s": round_s, "k1_tiles": tiles,
            "launches": launches}
    log(f"population churn: {line}")
    return line


def time_population_kernels(gen, D_G: int, D_D: int) -> dict:
    """K1 at the population's chunk tiles [S, 64] @ [64, D_G], S = 24
    (the clustered rounds: 4 owned layers x the bound of 6 clusters) and
    S = 8 (the FedAvg rounds: 4 layers x 1 cluster, padded to 8), and at
    a dense clustered round of 2560 clients [24, 2560] @ [2560, D_D]
    (theta 6.9 GB), each checked against its plain version and timed
    beside torch.matmul; K2 at N=512, M=6 (checked on exact inputs, then
    timed)."""
    from repro_torch.models.gan import DISC_MIDDLE_FEATURES
    k1 = {"chunk_s24": time_clustered_agg(gen, 24, POP_CHUNK, D_G),
          "chunk_s8": time_clustered_agg(gen, 8, POP_CHUNK, D_G),
          "dense_k2560": time_clustered_agg(gen, 24, 2560, D_D, iters=20)}
    check_kmeans_assign(gen, POP_CLIENTS, 6, DISC_MIDDLE_FEATURES,
                        "population_512")
    k2 = time_kmeans_assign(gen, POP_CLIENTS, 6, DISC_MIDDLE_FEATURES)
    return {"clustered_agg": k1, "kmeans_assign": k2}


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


def adam_bound(steps: int, b1: float, b2: float = 0.999,
               start: int = 0) -> float:
    """Sum over Adam's steps start < t <= start + steps of the largest
    step Adam can take at step t in units of lr, sqrt(sum_i a_i^2 / u_i)
    over the bias-corrected weights a_i of the first moment and u_i of
    the second (1 at t = 1; 1.054 at t = 2 with b1 = 0.5). A gradient
    that is zero up to rounding (a conv bias before BatchNorm) can take
    either sign on two devices, so two runs from one state drift apart
    by up to 2 lr times this sum."""
    import numpy as np
    total = 0.0
    for t in range(start + 1, start + steps + 1):
        a = np.array([(1 - b1) * b1 ** (t - i) for i in range(1, t + 1)])
        u = np.array([(1 - b2) * b2 ** (t - i) for i in range(1, t + 1)])
        a, u = a / (1 - b1 ** t), u / (1 - b2 ** t)
        total += float(np.sqrt((a ** 2 / u).sum()))
    return total


def check_metrics_pipeline(device: str = "cuda") -> dict:
    """The reference's ``test_metrics_pipeline_sane`` on the card: a
    classifier trained on real gratings scores > 0.6 on a held-out set,
    and its dataset score of real images beats that of uniform noise."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import make_class_balanced
    from repro_torch.metrics import dataset_score, evaluate
    from repro_torch.models.classifier import (predict, predict_proba,
                                               train_classifier)
    imgs, labs = make_class_balanced("gratings", 40, seed=0)
    test_i, test_l = make_class_balanced("gratings", 15, seed=99)
    params = train_classifier(torch.Generator().manual_seed(0), imgs, labs,
                              epochs=5, device=device)
    acc = evaluate(test_l, predict(params, test_i)).accuracy
    score_real = dataset_score(predict_proba(params, test_i))
    noise = np.random.default_rng(0).uniform(-1, 1, test_i.shape
                                              ).astype(np.float32)
    score_noise = dataset_score(predict_proba(params, noise))
    if not acc > 0.6:
        raise AssertionError(f"classifier on real gratings: accuracy {acc}")
    if not score_real > score_noise:
        raise AssertionError(f"dataset score of real images {score_real} "
                             f"<= that of noise {score_noise}")
    return {"accuracy": acc, "score_real": score_real,
            "score_noise": score_noise}


QUALITY_CPU_ATTRS = {"fedgan": ("g_params", "d_params"),
                     "mdgan": ("g_server", "d_params"),
                     "fed_split_gan": ("g_server", "d_heads", "d_tail")}


def check_quality_cpu_agreement(device: str = "cuda") -> dict:
    """FedGAN, MD-GAN and Fed-Split-GAN train one epoch (3 clients, batch
    4, 2 steps, a federation) on the card and on the CPU from one state
    and one seed's numpy draws: parameters agree to 2 lr times
    ``adam_bound``. The classifier trained on both from one ``params=``
    gives logits within 1e-4 of the largest."""
    import numpy as np
    import torch
    from repro_torch.baselines import ALL_BASELINES, BaselineConfig
    from repro_torch.data.partition import build_scenario
    from repro_torch.data.synthetic import make_class_balanced
    from repro_torch.models.classifier import (cnn_apply, init_cnn,
                                               train_classifier)
    from repro_torch.tree import tree_items, tree_map
    clients = build_scenario("2dom_iid", num_clients=4, base_size=16,
                             seed=0)[:3]
    cfg = BaselineConfig(batch=4, steps_per_epoch=2, federate_every=1,
                         seed=0)
    tol = 2 * cfg.lr * adam_bound(2, cfg.adam_b1)
    out = {"tol": tol}
    for name, attrs in QUALITY_CPU_ATTRS.items():
        cpu = ALL_BASELINES[name](clients, cfg, device="cpu")
        card = ALL_BASELINES[name](clients, cfg, device=device)
        for a in attrs:
            setattr(card, a, tree_map(lambda x: x.to(card.device),
                                      getattr(cpu, a)))
        m_cpu, m_card = cpu.train_epoch(), card.train_epoch()
        worst = max(float((x - y.cpu()).abs().max())
                    for a in attrs
                    for (_, x), (_, y) in zip(tree_items(getattr(cpu, a)),
                                              tree_items(getattr(card, a))))
        if not worst <= tol:
            raise AssertionError(f"{name}: CPU vs card parameters differ by "
                                 f"{worst} > {tol}")
        out[name] = {"max_abs_diff": worst, "loss_cpu": m_cpu,
                     "loss_card": m_card}
    imgs, labs = make_class_balanced("gratings", 39, seed=0)
    start = init_cnn(torch.Generator().manual_seed(0), device="cpu")
    nets = {dev: train_classifier(None, imgs, labs, epochs=1, params=tree_map(
        lambda x: x.to(dev), start)) for dev in ("cpu", device)}
    test_i = torch.as_tensor(make_class_balanced("gratings", 3, seed=99)[0])
    with torch.no_grad():
        logits = {dev: cnn_apply(p, test_i.to(dev)).cpu()
                  for dev, p in nets.items()}
    err = float((logits["cpu"] - logits[device]).abs().max()
                / logits["cpu"].abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"classifier CPU vs card logits differ by "
                             f"{err} of the largest")
    out["classifier_logits_rel_err"] = err
    return out


def run_tables(device: str = "cuda") -> dict:
    """Paper Tables 23 and 17 through ``launch.ablation`` at the
    reference's sizes (6 clients, base size 96, 4 epochs, batch 16), on
    the default fused epochs: every metric finite; each table's rows
    printed."""
    import numpy as np
    from repro_torch.launch.ablation import run_ablation, run_kld_comparison
    out = {}
    for table, fn in (("table23", run_ablation),
                      ("table17", run_kld_comparison)):
        res = out[table] = fn(device=device)
        for name, r in res.items():
            for dom, m in r["metrics"].items():
                if not all(np.isfinite(v) for v in m.values()):
                    raise AssertionError(f"{table}/{name}/{dom}: metrics "
                                         f"not finite: {m}")
                log(f"{table}/{name}/{dom}: acc {m['accuracy']:.3f} f1 "
                    f"{m['f1']:.3f} score {m['score']:.2f} fid "
                    f"{m['fid']:.1f} (train {r['train_s']:.2f}s, eval "
                    f"{r['eval_s']:.2f}s, rounds {r['rounds']})")
    return out


QUALITY_SCENARIO = "2dom_noniid"
QUALITY_CLIENTS, QUALITY_BASE_SIZE, QUALITY_EPOCHS = 8, 128, 6


def run_quality(device: str = "cuda") -> dict:
    """The quality phase (docstring, 4c): HuSCF-GAN with K1/K2's counts
    set to 0 just before and read just after, then the five baselines,
    each scored by ``launch.quality.evaluate_trainer``; every metric
    finite; the metrics pipeline on real data; card against CPU; one
    profiled FedGAN step at 8 clients."""
    import numpy as np
    import torch
    from repro_torch.baselines import ALL_BASELINES, BaselineConfig
    from repro_torch.baselines.fedgan import FedGANTrainer
    from repro_torch.data.partition import build_scenario
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    from repro_torch.launch.quality import run_scenario
    t_phase = time.perf_counter()
    kw = dict(num_clients=QUALITY_CLIENTS, base_size=QUALITY_BASE_SIZE,
              epochs=QUALITY_EPOCHS, batch=16, seed=0, device=device)
    wa.launches = 0
    km.launches = 0
    results = run_scenario(QUALITY_SCENARIO, algos=("huscf",), **kw)
    launches = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched in the "
                                 "quality phase's HuSCF-GAN run")
    results.update(run_scenario(QUALITY_SCENARIO,
                                algos=tuple(sorted(ALL_BASELINES)), **kw))
    for algo, r in results.items():
        for dom, m in r["metrics"].items():
            bad = [k for k in ("accuracy", "f1", "fpr", "score", "fid")
                   if not np.isfinite(m[k])]
            if bad:
                raise AssertionError(f"{algo}/{dom}: metrics {bad} are not "
                                     f"finite: {m}")
    pipeline = check_metrics_pipeline(device)
    cpu_agreement = check_quality_cpu_agreement(device)
    tables = run_tables(device)
    clients = build_scenario(QUALITY_SCENARIO, num_clients=QUALITY_CLIENTS,
                             base_size=QUALITY_BASE_SIZE, seed=0)
    fed = FedGANTrainer(clients, BaselineConfig(batch=16, federate_every=2,
                                                seed=0), device=device)
    fed.train_steps(1)
    profile = device_profile(lambda: fed.train_steps(1), top_n=4)
    for algo, r in results.items():
        log(f"quality {algo}: train {r['train_s']:.2f}s ({r['steps']} steps, "
            f"{r['s_per_step'] * 1e3:.1f} ms/step), eval {r['eval_s']:.2f}s; "
            + "; ".join(f"{d} acc {m['accuracy']:.3f} fid {m['fid']:.1f}"
                        for d, m in r["metrics"].items()))
    return {"scenario": QUALITY_SCENARIO, "clients": QUALITY_CLIENTS,
            "base_size": QUALITY_BASE_SIZE, "batch": 16,
            "epochs": QUALITY_EPOCHS, "federate_every": 2,
            "reduced": [f"clients: {QUALITY_CLIENTS} (the paper's "
                        "scenarios: 100)",
                        f"base_size: {QUALITY_BASE_SIZE} images per client "
                        "(the paper's: 600)",
                        f"epochs: {QUALITY_EPOCHS} of a short run (the "
                        "paper trains to convergence)"],
            "algos": {algo: {k: r[k] for k in ("train_s", "s_per_step",
                                               "epochs", "steps", "eval_s",
                                               "metrics")}
                      for algo, r in results.items()},
            "huscf_launches": launches, "tables": tables,
            "metrics_pipeline": pipeline, "cpu_agreement": cpu_agreement,
            "fedgan_step_profile": profile,
            "phase_s": time.perf_counter() - t_phase}


# --- the LM family (phase 4d) ------------------------------------------------

LM_ARCH = "granite-3-2b"
LM_TRAIN = dict(steps=5, batch=16, seq=128)
LM_SERVE = dict(batch=4, prompt=64, gen=16)
# every other arch: one step at batch 2, seq 128, and a short serve
LM_OTHER_TRAIN = dict(batch=2, seq=128)
LM_OTHER_SERVE = dict(batch=2, prompt=32, gen=4)
LM_FULL_DEPTH = ("granite-moe-1b-a400m", "whisper-tiny")
# command-r-plus-104b: one full-width layer holds 4.7 B parameters (the
# 256000 x 12288 embedding alone 3.1 B); bf16 weights and gradients plus
# float32 Adam moments and the update's float32 temporaries come to
# ~76 GB before activations, which does not fit the 80 GB card
LM_SERVE_ONLY = ("command-r-plus-104b",)
# decode vs prefill in bf16: both paths compute the same function, but
# their products reduce in other shapes (an [S, d] GEMM and chunked
# attention against a [1, d] GEMM and full-softmax decode attention), so
# each of the ~6 bf16 rounding points per layer may round an element the
# other way (2^-9 relative); over 40 layers such flips add up like a
# random walk, ~sqrt(240) * 2^-9 = 3 % of an activation's size. The
# float32 logits are held to 5 % of the largest one.
LM_DECODE_TOL = 5e-2
LM_DECODE_CHECKS = 4            # decode steps held against a prefill
# the card against the CPU on the smoke configs (float32, TF32 off): the
# CPU parity tests' tolerance, 1e-4 of the largest magnitude
LM_CARD_CPU_TOL = 1e-4


def _rel_err(got, want) -> float:
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()
                 / torch.clamp(want.abs().max(), min=1e-30))


def _lm_inputs(cfg, batch: int, seq: int, device, seed: int = 0):
    """Seeded tokens plus a VLM's patch embeddings or an encoder's frames."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                        dtype=torch.int32, device=device)
    extra = {}
    name = ("enc_frames" if cfg.is_encoder_decoder else
            "prefix_embeds" if cfg.frontend == "vision" else None)
    if name:
        extra[name] = torch.tensor(rng.normal(
            0, 1, (batch, cfg.num_prefix_embeds, cfg.d_model)),
            dtype=torch.float32, device=device)
    return toks, extra


def without_sync(fn):
    """``fn()`` with every host synchronisation an error (torch's sync
    debug mode), as phase 3c runs the search; returns its result."""
    import torch
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _free_cuda() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_granite_train(train_main, device: str) -> dict:
    """granite-3-2b at its published config through ``launch.train``:
    5 steps at batch 16, seq 128; then one more step timed (with no
    host synchronisation: gradient clipping reads nothing back) and one
    profiled."""
    import torch
    from repro_torch.data.tokens import lm_batches
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.nn import tree_size
    from repro_torch.optim.optimizers import adam
    from repro_torch.optim.schedules import warmup_cosine
    a = LM_TRAIN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, opt_state, losses = train_main(
        ["--arch", LM_ARCH, "--steps", str(a["steps"]), "--batch",
         str(a["batch"]), "--seq", str(a["seq"]), "--device", device])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses) or not all_finite(params):
        raise AssertionError(f"{LM_ARCH} training: losses {losses} or "
                             "parameters not finite")
    step, _ = T.make_train_step(cfg, adam(warmup_cosine(3e-4, 10, 20),
                                          grad_clip=1.0))
    toks, labs = next(lm_batches(cfg.vocab, a["batch"], a["seq"], seed=1))
    batch = lm_batch(cfg, toks, labs, a["steps"], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, m = without_sync(lambda: step(params, opt_state,
                                                     batch))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    prof = device_profile(lambda: step(params, opt_state, batch), top_n=6)
    n_params = tree_size(params)
    del params, opt_state
    _free_cuda()
    log(f"LM {LM_ARCH} train: {a['steps']} steps in {train_s:.1f}s, losses "
        f"{losses}, step {step_s:.3f}s, busy share "
        f"{prof['busy_share']:.3f}, peak {peak / 2**30:.1f} GiB")
    return {"arch": LM_ARCH, "params": n_params, **a, "losses": losses,
            "train_s": train_s, "step_s": step_s, "peak_bytes": peak,
            "tokens_per_s": a["batch"] * a["seq"] / step_s,
            "step_profile": prof}


def lm_granite_serve(serve_main, device: str) -> dict:
    """granite-3-2b through ``launch.serve`` (batch 4, prompt 64, gen
    16); decode logits against prefill logits over the same tokens;
    the decode tail once with no host synchronisation, once profiled
    (ms and launches per token)."""
    import torch
    from repro_torch.launch.serve import decode_tail
    from repro_torch.models import transformer as T
    a = LM_SERVE
    res = serve_main(["--arch", LM_ARCH, "--batch", str(a["batch"]),
                      "--prompt-len", str(a["prompt"]), "--gen",
                      str(a["gen"]), "--device", device])
    cfg, params, prompts = res["cfg"], res["params"], res["prompts"]
    toks = torch.as_tensor(res["tokens"], device=prompts.device)
    if toks.shape != (a["batch"], a["gen"]) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"served tokens {tuple(toks.shape)} out of "
                             "shape or vocabulary")
    _, cache = T.prefill(cfg, params, prompts, margin=a["gen"] + 16)
    errs = []
    for j in range(LM_DECODE_CHECKS):
        dec, cache = T.decode_step(cfg, params, toks[:, j], cache)
        pre, _ = T.prefill(cfg, params, torch.cat([prompts, toks[:, :j + 1]],
                                                  1), margin=16)
        errs.append(_rel_err(dec, pre))
    if max(errs) > LM_DECODE_TOL:
        raise AssertionError(f"decode vs prefill logits differ by {errs} "
                             f"of the largest (tolerance {LM_DECODE_TOL})")
    check_decode_without_sync(cfg, params, prompts, {}, a["gen"])
    logits, cache = T.prefill(cfg, params, prompts, margin=a["gen"] + 16)
    cur0 = torch.argmax(logits, -1).to(torch.int32)
    prof = device_profile(lambda: decode_tail(cfg, params, cur0, cache,
                                              a["gen"]), top_n=6)
    n_dec = a["gen"] - 1
    out = {"arch": LM_ARCH, **a,
           "prefill_tok_per_s": res["prefill_tok_per_s"],
           "decode_tok_per_s": res["decode_tok_per_s"],
           "prefill_s": res["prefill_s"], "decode_s": res["decode_s"],
           "ms_per_token": prof["wall_s"] / n_dec * 1e3,
           "launches_per_token": prof["kernels"] / n_dec,
           "decode_busy_share": prof["busy_share"],
           "decode_vs_prefill_rel_err": errs,
           "decode_vs_prefill_tol": LM_DECODE_TOL, "decode_profile": prof}
    del res, params, cache
    _free_cuda()
    log(f"LM {LM_ARCH} serve: prefill {out['prefill_tok_per_s']:.0f} tok/s, "
        f"decode {out['decode_tok_per_s']:.0f} tok/s, "
        f"{out['ms_per_token']:.2f} ms and {out['launches_per_token']:.0f} "
        f"launches per token; decode vs prefill {max(errs):.3e}")
    return out


def check_decode_without_sync(cfg, params, prompts, inputs, gen: int
                              ) -> None:
    """A fresh prefill, then ``gen - 1`` greedy decode steps with every
    host synchronisation an error: the decode loop reads nothing back
    per token."""
    import torch
    from repro_torch.launch.serve import decode_tail
    from repro_torch.models import transformer as T
    logits, cache = T.prefill(cfg, params, prompts, margin=gen + 16,
                              **inputs)
    cur0 = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    without_sync(lambda: decode_tail(cfg, params, cur0, cache, gen))
    torch.cuda.synchronize()


def lm_other_archs(train_main, serve_main, device: str) -> dict:
    """Every other arch at full width, depth cut to one super-block
    (granite-moe and whisper at full depth): one ``launch.train`` step
    and one short ``launch.serve``, then its decode loop with no host
    synchronisation; command-r-plus serves only."""
    import torch
    from repro_torch.configs import get_config, list_archs
    out = {}
    for arch in list_archs():
        if arch == LM_ARCH:
            continue
        full = get_config(arch)
        layers = (full.n_layers if arch in LM_FULL_DEPTH
                  else len(full.block_pattern))
        cut = ["--layers", str(layers)] if layers != full.n_layers else []
        entry = {"layers": layers, "reduced": (
            [f"n_layers: {full.n_layers} -> {layers} (one super-block)"]
            if cut else [])}
        if arch in LM_SERVE_ONLY:
            entry["train"] = ("skipped: one full-width layer with Adam "
                              "needs ~76 GB before activations, more than "
                              "the card's 80 GB leaves")
        else:
            a = LM_OTHER_TRAIN
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, params, _, losses = train_main(
                ["--arch", arch, "--steps", "1", "--batch", str(a["batch"]),
                 "--seq", str(a["seq"]), "--device", device] + cut)
            torch.cuda.synchronize()
            loss = float(losses[0])
            if not math.isfinite(loss) or not all_finite(params):
                raise AssertionError(f"{arch}: loss {loss} or parameters "
                                     "not finite after a step")
            entry.update(train_s=time.perf_counter() - t0, loss=loss,
                         train_peak_bytes=torch.cuda.max_memory_allocated(),
                         **{f"train_{k}": v for k, v in a.items()})
            del params
            _free_cuda()
        a = LM_OTHER_SERVE
        t0 = time.perf_counter()
        res = serve_main(["--arch", arch, "--batch", str(a["batch"]),
                          "--prompt-len", str(a["prompt"]), "--gen",
                          str(a["gen"]), "--device", device] + cut)
        toks = res["tokens"]
        if toks.shape != (a["batch"], a["gen"]) or toks.min() < 0 or \
                toks.max() >= full.vocab or \
                not bool(torch.isfinite(res["prefill_logits"]).all()):
            raise AssertionError(f"{arch}: served tokens or logits invalid")
        check_decode_without_sync(res["cfg"], res["params"], res["prompts"],
                                  res["inputs"], a["gen"])
        entry.update(serve_s=time.perf_counter() - t0,
                     prefill_tok_per_s=res["prefill_tok_per_s"],
                     decode_tok_per_s=res["decode_tok_per_s"],
                     **{f"serve_{k}": v for k, v in a.items()})
        del res
        _free_cuda()
        log(f"LM {arch}: {entry}")
        out[arch] = entry
    return out


def lm_split(device: str) -> dict:
    """The split transformer on granite-3-2b at full width, 5 layers (the
    least ``default_groups`` leaves a trunk of one super-block with): 3
    ``make_split_train_step`` steps and one ``federate_split_lm`` round;
    then clients marked with constants federate without crossing
    clusters."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import split_transformer as ST
    from repro_torch.tree import tree_leaves
    full = get_config(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=5)
    groups = ST.default_groups(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = ST.init_split_lm(cfg, groups, gen, device)
    step, opt_init = ST.make_split_train_step(cfg, groups, lr=1e-4)
    opt = opt_init(params)
    rng = np.random.default_rng(0)
    batch = {k: {g.name: torch.tensor(rng.integers(
        0, cfg.vocab, (g.n_clients, 2, 128)), device=device) for g in groups}
        for k in ("tokens", "labels")}
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    steps_s = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in losses) or not all_finite(params):
        raise AssertionError(f"split LM: losses {losses} or parameters not "
                             "finite")
    labels = np.array([0, 0, 1, 1])
    weights = np.array([0.5, 0.5, 0.25, 0.75])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fed = ST.federate_split_lm(params, groups, weights, labels)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    if not all_finite(fed):
        raise AssertionError("split LM federation: not finite")
    marked = {"server": params["server"], "clients": {}}
    for gi, g in enumerate(groups):
        c = dict(params["clients"][g.name])
        t = c["embed"]["table"]
        marks = torch.arange(g.n_clients, device=device) + 10 * gi
        c["embed"] = {"table": torch.zeros_like(t)
                      + marks[:, None, None].to(t.dtype)}
        marked["clients"][g.name] = c
    out = ST.federate_split_lm(marked, groups, weights, labels)
    want = {groups[0].name: 0.5, groups[1].name: 10.75}
    for name, v in want.items():
        t = out["clients"][name]["embed"]["table"]
        if not bool((t == v).all()):
            raise AssertionError(f"split LM federation mixed clusters: "
                                 f"{name} tables are not all {v}")
    for name in want:
        heads = out["clients"][name]["head"]
        if not all(bool((x[0] == x[1]).all()) for x in tree_leaves(heads)):
            raise AssertionError(f"split LM federation: {name}'s head "
                                 "blocks differ within one cluster")
    n_params = sum(x.numel() for x in tree_leaves(params))
    del params, opt, fed, marked, out
    _free_cuda()
    log(f"LM split: losses {losses}, 3 steps {steps_s:.2f}s, round "
        f"{round_s:.3f}s")
    return {"arch": LM_ARCH, "layers": 5, "params": n_params,
            "reduced": [f"n_layers: {full.n_layers} -> 5 (the least "
                        "default_groups allows)"],
            "groups": [dataclasses.astuple(g) for g in groups],
            "batch": 2, "seq": 128, "losses": losses, "steps_s": steps_s,
            "round_s": round_s, "cluster_isolation": True}


def lm_card_vs_cpu(device: str) -> dict:
    """Every arch's smoke config (float32) from one CPU initialisation:
    forward logits, prefill logits and cache, and 2 decode steps on the
    card against the CPU."""
    import torch
    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_items, tree_map
    out = {}
    for arch in list_archs():
        cfg = get_smoke_config(arch)
        p_cpu = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
        p_dev = tree_map(lambda x: x.to(device), p_cpu)
        seq = 12 if cfg.is_encoder_decoder else 24
        toks, extra = _lm_inputs(cfg, 2, seq, "cpu")
        extra_dev = {k: v.to(device) for k, v in extra.items()}
        errs = {}
        lc, _ = T.forward_train(cfg, p_cpu, toks, **extra)
        ld, _ = T.forward_train(cfg, p_dev, toks.to(device), **extra_dev)
        errs["forward"] = _rel_err(ld.detach(), lc.detach())
        pc, cc = T.prefill(cfg, p_cpu, toks, margin=4, **extra)
        pd, cd = T.prefill(cfg, p_dev, toks.to(device), margin=4,
                           **extra_dev)
        errs["prefill"] = _rel_err(pd, pc)

        def cache_err(a, b):
            return max(_rel_err(x, dict(tree_items(b))[path])
                       for path, x in tree_items(a) if path != ("length",))
        errs["prefill_cache"] = cache_err(cd, cc)
        for i in range(2):
            tok = torch.argmax(pc, -1).to(torch.int32)
            pc, cc = T.decode_step(cfg, p_cpu, tok, cc)
            pd, cd = T.decode_step(cfg, p_dev, tok.to(device), cd)
            errs[f"decode{i}"] = _rel_err(pd, pc)
            errs[f"decode{i}_cache"] = cache_err(cd, cc)
        worst = max(errs.values())
        if worst > LM_CARD_CPU_TOL:
            raise AssertionError(f"{arch}: card vs CPU {errs} (tolerance "
                                 f"{LM_CARD_CPU_TOL})")
        out[arch] = worst
    log(f"LM card vs CPU (smoke configs): worst {max(out.values()):.3e}")
    return {"worst_rel_err": out, "tol": LM_CARD_CPU_TOL}


def run_lm(train_main, serve_main, smi: str, device: str = "cuda") -> dict:
    """Phase 4d: the LM family (docstring)."""
    t_phase = time.perf_counter()
    _free_cuda()
    out = {"card": smi,
           "train": lm_granite_train(train_main, device),
           "serve": lm_granite_serve(serve_main, device),
           "archs": lm_other_archs(train_main, serve_main, device),
           "split": lm_split(device),
           "card_vs_cpu": lm_card_vs_cpu(device),
           "kernels_on_path": "none: the LM path runs chunked_attention "
                              "and decode_attention in plain torch, as the "
                              "reference runs plain jnp (K1-K4 stay held "
                              "against their plain versions below)"}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"LM phase {out['phase_s']:.1f}s")
    return out


def time_slice(tr) -> dict:
    """Wall time of one epoch's training steps (on captured graphs) and
    of one clustered federation round, each ending in a device
    synchronize."""
    import numpy as np
    import torch
    steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
    warm_graphs(tr, steps)
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


def busy_us(spans) -> float:
    """Length of the union of (start, end) intervals: the time at least
    one device activity ran."""
    total, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(spans):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return total if cur_e is None else total + cur_e - cur_s


HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def device_profile(fn, per: int = 1, top_n: int = 6) -> dict:
    """``fn`` once under torch.profiler: wall time, device busy time and
    share (the union of the device activities' intervals over wall
    time), the summed activity time beside it (above the busy time when
    activities overlap), the streams they ran on, kernel launches (device
    kernels, and the host's launch calls: kernels, graphs, copies and
    fills), and the kernels that take the most device time; launches and
    times in the list are per ``per`` (e.g. per training step)."""
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
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in events) / 1e6
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:top_n]
    host = sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CUDA
               and e.key in HOST_LAUNCH_CALLS)
    return {"wall_s": wall, "device_busy_s": busy, "busy_share": busy / wall,
            "device_sum_s": sum(e.self_device_time_total for e in dev) / 1e6,
            "streams": len({e.device_resource_id for e in events}),
            "kernels": sum(e.count for e in dev) / per,
            "host_launches": host / per,
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


# graph epoch vs step loop: the last step's losses, after parameters that
# may differ by 2 lr times Adam's bound (a fresh Adam after a churn moves
# every parameter by about lr per step, whatever its gradient's size)
FUSED_LOSS_RTOL = 1e-2


def warm_graphs(tr, steps: int) -> None:
    """Fused epochs until the trainer's graphs are captured and have run
    once: the first step after construction or a regroup runs eagerly,
    and a graph's first launch uploads it."""
    tr.train_steps(steps)
    if not tr._graph_pool.graphs:
        tr.train_steps(steps)
    tr.train_steps(steps)


def clone_state(state: dict) -> dict:
    """A copy of a trainer state on its device, Adam's steps included."""
    import torch
    from repro_torch.optim.optimizers import AdamState
    from repro_torch.tree import tree_map

    def c(x):
        return x.clone() if isinstance(x, torch.Tensor) else x
    return {k: (AdamState(c(v.step), tree_map(c, v.mu), tree_map(c, v.nu))
                if isinstance(v, AdamState) else tree_map(c, v))
            for k, v in state.items()}


def snapshot(tr) -> dict:
    """What a fused epoch starts from: the state, the EMA and its flag,
    and the training generator's state."""
    return {"state": clone_state(tr.state), "ema": tr._mid_ema.clone(),
            "ema_init": tr._ema_init, "gen": tr._train_gen.get_state()}


def restore(tr, snap: dict, ema_init=None) -> None:
    """Put a snapshot back as a caller would: new tensors assigned to the
    trainer (the fused path copies them into its own)."""
    tr.state = clone_state(snap["state"])
    tr._mid_ema = snap["ema"].clone()
    tr._ema_init = snap["ema_init"] if ema_init is None else ema_init
    tr._train_gen.set_state(snap["gen"])


def run_steps(tr, fused: bool, steps: int) -> dict:
    """``steps`` training steps as a graph epoch or as the step loop, on
    the same trainer; returns the losses, a copy of the state and the
    EMA."""
    import torch
    tr.cfg.fused_epoch = fused
    try:
        m = tr.train_steps(steps)
    finally:
        tr.cfg.fused_epoch = True
    torch.cuda.synchronize()
    return {"losses": m, "state": clone_state(tr.state),
            "ema": tr._mid_ema.clone()}


def param_diff(a: dict, b: dict, stats: bool = False) -> float:
    """Largest |a - b| over both nets' learnable parameters of two states
    (``stats``: over their BatchNorm running statistics instead, relative
    to each leaf's scale, at least 1)."""
    from repro_torch.tree import tree_items
    return max(float((x - y).abs().max()) / (
        max(1.0, float(y.abs().max())) if stats else 1.0)
        for net in ("G", "D")
        for (p, x), (_, y) in zip(tree_items(a[net]), tree_items(b[net]))
        if (p[-1] in ("mean", "var")) == stats)


def graph_vs_loop(tr, snap: dict, steps: int, what: str) -> dict:
    """From one state and generator state: a graph epoch against the
    step loop. Learnable parameters within 2 lr times ``adam_bound`` over
    the epoch's Adam steps (cuDNN's weight gradients are not
    deterministic, so two loops differ too), losses finite and within
    FUSED_LOSS_RTOL; the differences of the BatchNorm statistics and the
    EMA, which follow the activations, are reported."""
    import torch
    from repro_torch.tree import tree_leaves
    restore(tr, snap)
    g = run_steps(tr, True, steps)
    restore(tr, snap)
    lp = run_steps(tr, False, steps)
    tol = 2 * tr.cfg.lr * adam_bound(steps, tr.cfg.adam_b1,
                                     start=int(snap["state"]["opt_d"].step))
    dp = param_diff(g["state"], lp["state"])
    ds = param_diff(g["state"], lp["state"], stats=True)
    de = float((g["ema"] - lp["ema"]).abs().max())
    dl = max(abs(g["losses"][k] - lp["losses"][k]) / abs(lp["losses"][k])
             for k in lp["losses"])
    if not (dp <= tol and dl <= FUSED_LOSS_RTOL and all(
            math.isfinite(v) for v in g["losses"].values())):
        raise AssertionError(f"{what}: graph epoch vs step loop: params "
                             f"{dp} (tol {tol}), EMA {de}, losses "
                             f"{g['losses']} vs {lp['losses']}")
    bits = all(torch.equal(x, y) for net in ("G", "D")
               for x, y in zip(tree_leaves(g["state"][net]),
                               tree_leaves(lp["state"][net])))
    log(f"fused epoch {what}: graph vs loop max |dparam| {dp:.3e} (tol "
        f"{tol:.3e}), BN statistics rel {ds:.3e}, EMA {de:.3e}, losses rel "
        f"{dl:.3e}, bit-equal {bits}")
    return {"max_abs_dparam": dp, "tol": tol, "max_rel_dstats": ds,
            "max_abs_dema": de, "loss_rel": dl, "bit_equal": bits}


def check_fused_epoch(tr, ckpt: str, device: str = "cuda") -> dict:
    """Phase 3b (docstring): the slice's fused epoch as CUDA graphs against
    the step loop on the same trainer, from one state and generator
    state; the timings of both; then agreement after a federation round,
    a checkpoint load and a churn. Returns the ``fused_epoch`` fields of
    the ``slice`` line."""
    import numpy as np
    import torch
    from repro_torch.bridge import state_from_numpy, state_to_numpy
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.latency import DeviceProfile
    from repro_torch.data.partition import build_scenario
    steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
    s0 = snapshot(tr)
    out = {"steps": steps}

    # 1-2. batches and the EMA after one step, bit for bit, with the EMA's
    # first observation (flag off) and a later one (flag on); the sampler
    # copies each batch into tensors made before the capture
    record, sample = {}, tr._sample

    def recording(gen):
        b = sample(gen)
        for f, d in b.items():
            for n, x in d.items():
                if (f, n) not in record:
                    record[(f, n)] = torch.empty_like(x)
                record[(f, n)].copy_(x)
        return b

    tr._drop_graphs()
    tr._sample = recording
    try:
        restore(tr, s0)
        tr.train_steps(1)                        # the eager warm-up
        for flag in (False, True):
            got = {}
            for fused in (True, False):
                restore(tr, s0, ema_init=flag)
                r = run_steps(tr, fused, 1)
                got[fused] = ({k: v.clone() for k, v in record.items()},
                              r["ema"])
            (bg, eg), (bl, el) = got[True], got[False]
            if not all(same_bits(bg[k], bl[k]) for k in bl):
                raise AssertionError(f"graph vs loop batches differ (EMA "
                                     f"flag {flag})")
            if not same_bits(eg, el):
                raise AssertionError(f"graph vs loop EMA after one step "
                                     f"differs (EMA flag {flag}) by "
                                     f"{float((eg - el).abs().max())}")
        log(f"fused epoch: batches ({len(record)} tensors) and the EMA "
            f"after one step bit-identical, EMA flag off and on")
    finally:
        del tr._sample
        tr._drop_graphs()
        record.clear()

    # the graph epoch's capture (after a warm-up epoch), then timings of
    # both paths in turns from the same state
    restore(tr, s0)
    warm_graphs(tr, steps)
    torch.cuda.synchronize()
    pool = tr._graph_pool
    out.update({"capture_s": pool.capture_s, "graphs": pool.graphs,
                "pool_bytes": pool.pool_bytes})
    walls = {True: [], False: []}
    for fused in (True, False, False, True):
        restore(tr, s0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(tr, fused, steps)
        walls[fused].append(time.perf_counter() - t0)
    out["epoch_s"] = {"graph": walls[True], "loop": walls[False]}
    for fused, name in ((True, "graph"), (False, "loop")):
        restore(tr, s0)
        tr.cfg.fused_epoch = fused
        try:
            tr.train_steps(steps)    # the restored leaves are copied in
            out[f"profile_{name}"] = device_profile(
                lambda: tr.train_steps(steps), per=steps)
        finally:
            tr.cfg.fused_epoch = True
    log(f"fused epoch: capture {out['capture_s']:.3f}s, pool "
        f"{out['pool_bytes']} bytes; epoch s graph {walls[True]} loop "
        f"{walls[False]}; busy share graph "
        f"{out['profile_graph']['busy_share']:.3f} loop "
        f"{out['profile_loop']['busy_share']:.3f}; host launches per step "
        f"graph {out['profile_graph']['host_launches']} loop "
        f"{out['profile_loop']['host_launches']}")

    # 3. the parameters after an epoch
    out["epoch"] = graph_vs_loop(tr, s0, steps, "from the trained state")
    # 4. a whole fused epoch dispatched with every host sync an error
    restore(tr, s0)
    without_sync(lambda: tr._fused_epoch(steps))
    torch.cuda.synchronize()
    log("fused epoch: dispatched under set_sync_debug_mode('error')")

    # 5. after a federation round, a checkpoint load and a churn
    restore(tr, s0)
    joiner = build_scenario("2dom_noniid", num_clients=8, base_size=24,
                            seed=1)[0]
    fast = DeviceProfile("ultrafast", 3.0e9, 64.0, 500e6)
    for event in ("federation_round", "checkpoint_load", "churn"):
        if event == "federation_round":
            tr.federate()
        elif event == "checkpoint_load":
            save_checkpoint(ckpt, state_to_numpy(tr.state), step=tr.epoch)
            tr.train_steps(steps)                # the carry moves on
            back, _ = load_checkpoint(ckpt, state_to_numpy(tr.state))
            tr.state = state_from_numpy(back, device)
        else:
            tr.apply_churn(leave=[0], join=[(joiner, fast)])
        snap = snapshot(tr)
        if event != "churn":
            # the replaced leaves are copied into the carry bit for bit
            tr._adopt_carry()
            from repro_torch.checkpoint.ckpt import tree_flatten
            if not all(map(same_bits, tree_flatten(tr.state)[0],
                           tree_flatten(snap["state"])[0])):
                raise AssertionError(f"{event}: the carry does not hold the "
                                     "replaced state")
        out[event] = graph_vs_loop(tr, snap, steps, f"after the {event}")
    return out


# the slice's launcher settings (``launch.train``'s defaults with
# --epochs 6 --federate-every 2), for trainers the smoke builds itself
SLICE_CLIENTS, SLICE_BASE_SIZE, SLICE_BATCH = 8, 128, 16
SLICE_EPOCHS, SLICE_FED_EVERY = 6, 2


def slice_trainer(cuts, split_program: bool, device: str = "cuda"):
    """The slice's trainer as the launcher builds it (scenario
    ``2dom_noniid``, ``PAPER_DEVICES[i % 7]``, seed 0), on given cuts
    (the GA's, so no search runs again), with ``split_program``."""
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.core.latency import PAPER_DEVICES
    from repro_torch.data.partition import build_scenario
    clients = build_scenario("2dom_noniid", num_clients=SLICE_CLIENTS,
                             base_size=SLICE_BASE_SIZE, seed=0)
    devices = [PAPER_DEVICES[i % 7] for i in range(SLICE_CLIENTS)]
    return HuSCFTrainer(clients, devices, cuts=cuts, device=device,
                        config=HuSCFConfig(batch=SLICE_BATCH,
                                           federate_every=SLICE_FED_EVERY,
                                           seed=0,
                                           split_program=split_program))


def time_executors(trainers: dict) -> dict:
    """Per named trainer (one per executor), from its current state: the
    capture seconds of its fused epoch's graphs; one epoch's wall time
    on graphs and on the step loop, the trainers in turns (a, b, b, a)
    for each path; and a fused epoch of one step, one replay of its
    graph, profiled (device kernels and host launch calls per step, busy
    share). Each state is put back."""
    import numpy as np
    import torch
    out, snaps = {}, {}
    for name, tr in trainers.items():
        steps = max(1, int(np.median(tr.sizes)) // tr.cfg.batch)
        snaps[name] = snapshot(tr)
        tr._drop_graphs()
        restore(tr, snaps[name])
        warm_graphs(tr, steps)
        torch.cuda.synchronize()
        out[name] = {"steps": steps, "capture_s": tr._graph_pool.capture_s,
                     "pool_bytes": tr._graph_pool.pool_bytes,
                     "epoch_s": {"graph": [], "loop": []}}
    names = list(trainers)
    for fused, path in ((True, "graph"), (False, "loop")):
        for name in names + names[::-1]:
            tr = trainers[name]
            restore(tr, snaps[name])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_steps(tr, fused, out[name]["steps"])
            out[name]["epoch_s"][path].append(time.perf_counter() - t0)
    for name, tr in trainers.items():
        restore(tr, snaps[name])
        tr.train_steps(1)            # a fused epoch of one step: its graph
        prof = device_profile(lambda: tr.train_steps(1))
        out[name].update(kernels_per_step_graph=prof["kernels"],
                         host_launches_per_step_graph=prof["host_launches"],
                         busy_share_graph=prof["busy_share"])
        restore(tr, snaps[name])
    return out


def as_tree(x):
    """Nested tuples, lists and dicts of tensors as nested dicts of
    detached tensors (``tree_items`` walks dicts only)."""
    if isinstance(x, (tuple, list)):
        return {i: as_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: as_tree(v) for k, v in x.items()}
    return x.detach() if hasattr(x, "detach") else x


def check_executors_bitexact(tr) -> None:
    """One training-mode forward of each net from the trainer's state
    through the compiled program's executor and the legacy loops, with
    cuDNN's deterministic algorithms: every output, captured middle and
    updated leaf bit for bit."""
    import torch
    from repro_torch.core.huscf import build_net_apply, build_net_apply_legacy
    from repro_torch.tree import tree_items
    torch.backends.cudnn.deterministic = True
    try:
        for net in ("G", "D"):
            inputs = slice_inputs(tr, net)
            runs = []
            for build in (build_net_apply, build_net_apply_legacy):
                apply = build(tr.groups, net, capture_middle=net == "D")
                with torch.no_grad():
                    runs.append(list(tree_items(as_tree(apply(
                        tr.state[net]["client"], tr.state[net]["server"],
                        inputs, True)))))
            (a, b) = runs
            if [p for p, _ in a] != [p for p, _ in b] or not all(
                    same_bits(x, y) for (_, x), (_, y) in zip(a, b)):
                raise AssertionError(f"{net}: the legacy executor's forward "
                                     "differs from the program's")
    finally:
        torch.backends.cudnn.deterministic = False
    log("legacy vs program executor: one forward of G and D bit for bit")


def slice_inputs(tr, net: str, batch: int = SLICE_BATCH, seed: int = 11):
    """Seeded layer-0 inputs of ``net`` for every group of ``tr``."""
    import torch
    from repro_torch.models.gan import Z_DIM
    gen = torch.Generator(device=tr.device).manual_seed(seed)
    out = {}
    for g in tr.groups:
        shape = ((g.size, batch, Z_DIM) if net == "G"
                 else (g.size, batch, 28, 28, 1))
        out[g.name] = (torch.randn(shape, generator=gen, device=tr.device),
                       torch.randint(0, 10, (g.size, batch), generator=gen,
                                     device=tr.device))
    return out


def run_legacy(tr, ref: dict, device: str = "cuda") -> dict:
    """Phase 3d (docstring): the slice with ``split_program=False`` on
    fused epochs against the program's run from the same seed
    (``ref``: its state and losses right after the launcher), then the
    legacy graphs against the legacy step loop, a replayed epoch with
    every host sync an error, the legacy S = 1 FedAvg, and the timings
    of both executors."""
    import numpy as np
    import torch
    from repro_torch.core.federation import N_LAYERS, fedavg_uniform
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa
    out = {"seconds": {}}
    clock = [time.perf_counter()]

    def lap(what: str) -> None:
        now = time.perf_counter()
        out["seconds"][what] = now - clock[0]
        clock[0] = now

    wa.launches = 0
    km.launches = 0
    t0 = time.perf_counter()
    lg = slice_trainer(tr.cuts, split_program=False, device=device)
    for _ in range(SLICE_EPOCHS):
        lg.train_epoch()
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = {"clustered_agg": wa.launches,
                       "kmeans_assign": km.launches}
    out["rounds"] = [d["mode"] for d in lg.fed_log]
    if out["rounds"] != [d["mode"] for d in tr.fed_log[:len(lg.fed_log)]] \
            or "clustered" not in out["rounds"]:
        raise AssertionError(f"legacy rounds {out['rounds']}")
    for name, n in out["launches"].items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "legacy executor's path")
    # cuDNN's weight gradients are not deterministic, so two runs drift
    # apart as graph_vs_loop's do: the parameters by up to 2 lr times
    # Adam's bound over every step, the losses as the graph epoch's
    # after the first epoch (later ones follow a chaotic game: reported)
    steps = max(1, int(np.median(lg.sizes)) // lg.cfg.batch)
    tol = 2 * lg.cfg.lr * adam_bound(steps * SLICE_EPOCHS, lg.cfg.adam_b1)
    dp = param_diff(lg.state, ref["state"])
    dl = [max(abs(a[k] - b[k]) / abs(b[k]) for k in b)
          for a, b in zip(lg.history, ref["losses"])]
    if not (dp <= tol and dl[0] <= FUSED_LOSS_RTOL and all(
            math.isfinite(v) for m in lg.history for v in m.values())):
        raise AssertionError(f"legacy vs program trainer: params {dp} (tol "
                             f"{tol}), losses rel by epoch {dl}")
    out["vs_program"] = {"max_abs_dparam": dp, "tol": tol,
                         "loss_rel_by_epoch": dl}
    log(f"legacy trainer vs program trainer (one seed): max |dparam| "
        f"{dp:.3e} (tol {tol:.3e}), losses rel by epoch "
        f"{[f'{x:.2e}' for x in dl]}; launches {out['launches']}; rounds "
        f"{out['rounds']}")

    lap("train")
    check_executors_bitexact(lg)
    # a replayed legacy epoch dispatched with every host sync an error
    warm_graphs(lg, steps)
    without_sync(lambda: lg._fused_epoch(steps))
    torch.cuda.synchronize()
    out["graph_vs_loop"] = graph_vs_loop(lg, snapshot(lg), steps,
                                         "legacy executor")
    lap("checks")

    # the legacy S = 1 FedAvg (K1's weighted_agg_flat per layer and leaf)
    wrapped = {g.name: {net: lg.state[net]["client"][g.name]
                        for net in ("G", "D")} for g in lg.groups}
    rounds, launches, secs = {}, {}, {}
    for fused in (True, False):
        wa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rounds[fused] = fedavg_uniform(lg.groups, wrapped, lg.sizes,
                                       n_layers=N_LAYERS, use_kernel=True,
                                       fused=fused, plan_cache={})
        torch.cuda.synchronize()
        secs[fused] = time.perf_counter() - t0
        launches[fused] = wa.launches
    worst = max_rel_diff(rounds[False], rounds[True])
    if not worst <= K1_RTOL or launches[False] <= launches[True]:
        raise AssertionError(f"legacy FedAvg vs fused FedAvg: {worst} (K1 "
                             f"launches {launches})")
    out["fedavg_legacy"] = {"max_rel_diff": worst,
                            "k1_launches": launches[False],
                            "fused_k1_launches": launches[True],
                            "legacy_s": secs[False], "fused_s": secs[True]}
    log(f"fedavg_uniform(fused=False) vs fused: max rel diff {worst:.3e}; "
        f"K1 launches {launches[False]} vs {launches[True]}")
    lap("fedavg")

    # both executors' epochs, in turns on their own trainers
    out["timing"] = time_executors({"program": tr, "legacy": lg})
    log("executor timings: " + json.dumps(
        {k: {f: v[f] for f in ("capture_s", "epoch_s",
                               "kernels_per_step_graph")}
         for k, v in out["timing"].items()}))
    lap("timing")
    lg._drop_graphs()
    tr._drop_graphs()
    return out


def check_no_concat(tr) -> dict:
    """Phase 3e (docstring): one training-mode forward and backward of
    each net at the slice's groups, batch 16, with the no-concat server
    schedule through the program's executor and through the legacy
    loops: loss, outputs, middles, updated leaves and gradients bit for
    bit (cuDNN's deterministic algorithms). The server's BatchNorm
    statistics must differ from the concat schedule's where a layer has
    more than one active group. Both schedules timed (CUDA events) and
    profiled (device kernels per forward and backward)."""
    import torch
    from repro_torch.core.huscf import (build_net_apply,
                                        build_net_apply_legacy,
                                        value_and_grad)
    from repro_torch.core.segments import compile_split_program
    from repro_torch.tree import tree_items, tree_leaves
    out = {}
    for net in ("G", "D"):
        inputs = slice_inputs(tr, net)
        params = tr.state[net]

        def fwd_bwd(apply):
            def loss_fn(p):
                res, nc, ns, mids = apply(p["client"], p["server"], inputs,
                                          True)
                loss = sum(y.float().mean() for y in res.values())
                return loss, (res, nc, ns, mids)
            return value_and_grad(loss_fn, params)

        applies = {(build.__name__, concat): build(
            tr.groups, net, capture_middle=net == "D",
            concat_groups=concat)
            for build, concat in ((build_net_apply, True),
                                  (build_net_apply, False),
                                  (build_net_apply_legacy, False))}
        torch.backends.cudnn.deterministic = True
        try:
            runs = {key: fwd_bwd(apply) for key, apply in applies.items()}
        finally:
            torch.backends.cudnn.deterministic = False
        a = list(tree_items(as_tree(runs["build_net_apply", False])))
        b = list(tree_items(as_tree(runs["build_net_apply_legacy", False])))
        if [p for p, _ in a] != [p for p, _ in b] or not all(
                same_bits(x, y) for (_, x), (_, y) in zip(a, b)):
            raise AssertionError(f"{net}: no-concat program vs legacy "
                                 "forward/backward differ")
        ns_concat = as_tree(runs["build_net_apply", True][1][2])
        ns_ghost = as_tree(runs["build_net_apply", False][1][2])
        differ = {}
        for step in compile_split_program(tr.groups, net).steps:
            stats = [(x, y) for (p, x), (_, y) in zip(
                tree_items(ns_concat[str(step.layer)]),
                tree_items(ns_ghost[str(step.layer)]))
                if p[-1] in ("mean", "var")]
            differ[step.layer] = not all(same_bits(x, y) for x, y in stats)
            if stats and differ[step.layer] != (len(step.active) > 1):
                raise AssertionError(
                    f"{net} layer {step.layer} ({len(step.active)} active "
                    f"groups): no-concat statistics differ from concat's: "
                    f"{differ[step.layer]}")
        if not any(differ.values()):
            raise AssertionError(f"{net}: no server layer with two groups")
        row = {"stats_differ_by_layer": differ,
               "grad_leaves": len(tree_leaves(runs["build_net_apply",
                                                   False][2]))}
        for concat, name in ((True, "concat"), (False, "no_concat")):
            fn = (lambda apply=applies["build_net_apply", concat]:
                  fwd_bwd(apply))
            row[f"{name}_ms"] = time_ms(fn, iters=10, warmup=2)
            row[f"{name}_kernels"] = device_profile(fn)["kernels"]
        out[net] = row
        log(f"no-concat {net}: program vs legacy bit for bit; fwd+bwd "
            f"{row['concat_ms']:.3f} ms concat vs {row['no_concat_ms']:.3f} "
            f"ms no-concat; kernels {row['concat_kernels']} vs "
            f"{row['no_concat_kernels']}")
    return out


def load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the example twins on the card: the quickstart and the LM twins at their
# defaults, the comparison cut to 2 of its 6 epochs
EXAMPLES = (("torch_quickstart", []),
            ("torch_multi_domain_comparison", ["--epochs", "2"]),
            ("torch_serve_lm", []),
            ("torch_split_lm_training", []))


def run_examples(device: str = "cuda") -> dict:
    """Phase 4e (docstring): the four example twins through their
    ``main``, each timed; every number they return finite; the
    quickstart reaches a clustered round with K1 and K2 launched."""
    import numpy as np
    import torch
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import weighted_agg as wa

    def finite(x) -> bool:
        if isinstance(x, dict):
            return all(finite(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return all(finite(v) for v in x if not isinstance(v, str))
        if isinstance(x, np.ndarray):
            return bool(np.isfinite(x).all())
        return not isinstance(x, (int, float)) or math.isfinite(x)

    out = {}
    for name, argv in EXAMPLES:
        wa.launches = 0
        km.launches = 0
        t0 = time.perf_counter()
        res = load_example(name).main(argv + ["--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        row = {"argv": argv, "s": time.perf_counter() - t0,
               "launches": {"clustered_agg": wa.launches,
                            "kmeans_assign": km.launches}}
        if not finite(res):
            raise AssertionError(f"{name}: non-finite result {res}")
        if name == "torch_quickstart":
            if res["rounds"][-1] != "clustered" or min(
                    row["launches"].values()) <= 0:
                raise AssertionError(f"quickstart: rounds {res['rounds']}, "
                                     f"launches {row['launches']}")
            row.update({k: res[k] for k in (
                "ga_latency", "groups", "rounds", "k", "silhouette",
                "accuracy", "f1", "fpr", "score")})
            row["last_losses"] = res["losses"][-1]
        elif name == "torch_multi_domain_comparison":
            row["rows"] = res
        elif name == "torch_serve_lm":
            row.update({k: res[k] for k in (
                "arch", "prefill_s", "decode_s", "decode_tok_per_s",
                "cache_tensors", "cache_mib")})
            row["tokens_shape"] = list(res["tokens"].shape)
        else:
            row.update(losses=res["losses"],
                       federated_at=res["federated_at"])
        out[name] = row
        log(f"example {name} {argv}: {row['s']:.1f}s")
    return out


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
    from repro_torch.launch.serve import main as lm_serve_main
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
    ckpt = os.path.join(ROOT, "build", "slice.ckpt")
    t0 = time.perf_counter()
    tr = train_main(["--arch", "huscf-gan", "--epochs", "6",
                     "--federate-every", "2", "--device", "cuda",
                     "--ckpt", ckpt])
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    counts = {"clustered_agg": wa.launches, "kmeans_assign": km.launches}
    # the program executor's run, which the legacy executor's is held to
    slice_ref = {"state": clone_state(tr.state), "losses": list(tr.history)}
    log(f"slice ran in {slice_s:.1f}s; launches {counts}; rounds "
        f"{[d['mode'] for d in tr.fed_log]}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")

    ckpt_leaves = check_checkpoint(tr, ckpt)
    check_slice(tr)
    legacy = check_legacy_oracle(tr)
    check_cpu_agreement()
    t0 = time.perf_counter()
    search = run_search()
    recut_slice = run_recut(train_main)
    recut_s = time.perf_counter() - t0
    gan_serve = check_gan_serving(serve_main)
    lm_serve = check_lm_serving(serve_main)
    t0 = time.perf_counter()
    population = run_population(train_main)
    population["phase_s"] = time.perf_counter() - t0
    pop_churn = population.pop("churn")
    quality = run_quality()
    t0 = time.perf_counter()
    legacy_run = run_legacy(tr, slice_ref)
    del slice_ref
    no_concat = check_no_concat(tr)
    legacy_run["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples = run_examples()
    examples["phase_s"] = time.perf_counter() - t0
    # the slice trainer's graphs hold a private pool that the LM phase's
    # 63 GiB peak needs room beside; they are captured again below
    tr._drop_graphs()
    _free_cuda()
    lm = run_lm(train_main, lm_serve_main, smi)
    kernels = check_kernels(tr)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["legacy_launches"] = legacy_run["launches"][k["name"]]
        k["recut_launches"] = recut_slice["launches"][k["name"]]
        k["quality_launches"] = quality["huscf_launches"][k["name"]]
    kernels[0]["s1"]["launches"] = legacy["k1_launches"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    pop_k = time_population_kernels(gen, population["k1_D"]["G"],
                                    population["k1_D"]["D"])
    by_s = population["k1_launches_by_S"]
    k1_rows = pop_k["clustered_agg"]
    kernels[0]["population"] = dict(k1_rows["chunk_s24"],
                                    launches=by_s.get("24", 0))
    kernels[0]["population_s8"] = dict(k1_rows["chunk_s8"],
                                       launches=by_s.get("8", 0))
    kernels[0]["dense_k2560"] = dict(k1_rows["dense_k2560"], launches=None)
    kernels[1]["population"] = dict(pop_k["kmeans_assign"],
                                    launches=population["k2_launches"])
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
                   "rounds": [d["mode"] for d in tr.fed_log],
                   "checkpoint_leaves": ckpt_leaves,
                   "legacy_oracle": legacy})
    timing["fused_epoch"] = check_fused_epoch(
        tr, os.path.join(ROOT, "build", "fused.ckpt"))
    timing["no_concat"] = no_concat
    timing["legacy"] = legacy_run
    print(json.dumps({"slice": timing}), flush=True)
    print(json.dumps({"examples": examples}), flush=True)
    print(json.dumps({"population": population}), flush=True)
    print(json.dumps({"serve": {"gan": gan_serve, "lm": lm_serve}}),
          flush=True)
    print(json.dumps({"recut": {
        "search": search, "slice": recut_slice,
        "population_churn": pop_churn,
        "population_stage1_ga_s": population["ga_s"],
        "phase_s": recut_s}}), flush=True)
    print(json.dumps({"quality": quality}), flush=True)
    print(json.dumps({"lm": lm}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
