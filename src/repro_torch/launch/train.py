"""Training launcher of the PyTorch port.

Two modes, as in ``repro.launch.train``:
  * huscf (``--arch huscf-gan``): the paper's split-federated GAN;
  * centralized LM training on synthetic token streams for any other
    ``--arch`` (``configs.list_archs()``), ``train_lm``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --smoke --steps 20 --device cpu

The GAN mode runs the paper's split-federated GAN over a heterogeneous client
population on one device, with the flags and the printed lines of
``python -m repro.launch.train --arch huscf-gan``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch huscf-gan \
      --epochs 6 --federate-every 2

``--device`` picks the device (default ``cuda``; asking for it on a
machine without CUDA raises). Kernels K1/K2 are on by default
(``--no-use-kernel`` runs their plain expressions). Float32 products
and convolutions run in full float32: TF32 is switched off. Epochs are
fused, as in the reference (``HuSCFConfig.fused_epoch``): on the card
each epoch is replays of a CUDA graph of the training step, with the
batches drawn on the device and the losses read back once; the launcher
prints ``fused epochs``. ``--per-step`` runs the per-step loop, the
reference's oracle, and prints ``per-step epochs``. Each epoch's line
gives its steps' time (the ``huscf.train_steps`` span of
``repro_torch.trace``); after a federation round a ``[train] round``
line gives its clustering, KLD and aggregation milliseconds and its
host reads.

Population scale: ``--cohort S`` samples S clients per federation
round, ``--agg-chunk c`` streams every aggregation in chunks of c
clients, and ``--ckpt PATH`` writes the final state in the reference's
checkpoint format and layouts:

  PYTHONPATH=src python -m repro_torch.launch.train --arch huscf-gan \
      --clients 512 --cohort 128 --agg-chunk 64 --epochs 4 \
      --federate-every 1 --base-size 24

``--reoptimize-every N`` re-runs the GA cut search on the device every
N federation rounds and regroups the population when it finds strictly
better cuts.

``--fed-devices N`` shards the training over N ranks, as the
reference's flag shards it over N devices. When N divides every profile
group's size, the step shards by client rows (``core.huscf``,
``step_sharded``): each rank holds and trains its block of every
group's clients, and the rounds aggregate each rank's own rows. When a
group does not divide, every rank holds the whole state and runs the
whole step, and only the rounds shard the client rows. The launcher
prints ``step=sharded`` or ``step=replicated``. The default is every
visible GPU on ``cuda`` and 1 on the CPU. N > 1 spawns N ranks
(``launch.mesh.run_ranks``: NCCL, one GPU each; gloo on the CPU) and
returns rank 0's summary, or joins the group that ``torchrun
--nproc-per-node N`` made (``WORLD_SIZE`` = N). N above the visible GPUs
on ``cuda`` raises. Only rank 0 prints and writes the checkpoint (of the
gathered state). 14 clients on the paper's 7 devices make 7 groups of
2, which 2 ranks divide:

  PYTHONPATH=src python -m repro_torch.launch.train --arch huscf-gan \
      --device cpu --fed-devices 2 --clients 14 --base-size 12 --batch 4 \
      --epochs 2 --federate-every 1

A sharded step runs all-reduces inside it, and its fused epochs (the
default) capture them in the epoch's CUDA graphs: with one GPU per rank
(NCCL) the graphs capture NCCL's all-reduce; ranks that share a card
(``launch.mesh.run_ranks`` with more ranks than GPUs, as ``chip_smoke.py``
phase 4f runs them) sum through the shared all-reduce kernel
(``kernels.shared_allreduce``). ``--per-step`` trains it on the loop
with gloo's or NCCL's own calls; gloo ranks spread over several cards
need it.

``train_lm`` takes Adam with a warm-up cosine schedule (10 warm-up
steps, ``max(steps, 20)`` in all) and global-norm clipping at 1.0 on
``data.tokens.lm_batches``; a VLM's patch embeddings and a whisper
encoder's frames for step ``i`` come from ``np.random.default_rng(i)``,
as in the reference. ``--smoke`` takes the reduced config, ``--layers N``
cuts the depth to N layers; ``--ckpt`` writes the final parameters
(bf16 leaves as their raw words).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import trace


def fed_ranks(args) -> int:
    """The ranks ``--fed-devices`` asks for: by default every visible GPU
    on ``cuda`` (at least 1) and 1 on the CPU; more than one rank per
    visible GPU on ``cuda`` is refused."""
    on_cuda = torch.device(args.device).type == "cuda"
    visible = torch.cuda.device_count() if on_cuda else 0
    n = args.fed_devices
    if n is None:
        n = max(visible, 1) if on_cuda else 1
    if n < 1:
        raise ValueError(f"--fed-devices {n}: at least one rank")
    if on_cuda and n > 1 and n > visible:
        raise ValueError(f"--fed-devices {n} asks for more ranks than the "
                         f"{visible} visible GPU(s), one rank per GPU")
    return n


def train_huscf_gan(args):
    """Train; returns the trainer, or, where the launcher spawned the
    ranks, rank 0's summary (``rank_summary``)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod

    n = fed_ranks(args)
    dev_type = torch.device(args.device).type
    if n > 1 and mesh_mod.world_size() != n:
        if not dist.is_initialized() and \
                int(os.environ.get("WORLD_SIZE", "1")) == n:
            # a rank of the group torchrun started
            rank = int(os.environ["RANK"])
            backend = mesh_mod.init_rank(rank, n, "env://", dev_type)
            if rank == 0:
                mesh_mod.log(f"joined torchrun's {n} ranks: {backend}")
        else:
            return mesh_mod.run_ranks(n, _huscf_rank, args,
                                      device_type=dev_type)[0]
    return _train_huscf(args, n)


def _huscf_rank(args) -> dict:
    return rank_summary(_train_huscf(args, fed_ranks(args)))


def rank_summary(tr) -> dict:
    """What a spawned rank hands back: losses, rounds, the mesh and
    whether the step sharded."""
    return {"history": tr.history,
            "rounds": [d["mode"] for d in tr.fed_log],
            "fed_ranks": 1 if tr.fed_mesh is None else tr.fed_mesh.size(),
            "step_sharded": tr.step_sharded,
            "groups": len(tr.groups), "ga_latency": tr.ga_latency}


def round_lines(recs) -> list:
    """One line per federation round among ``recs`` (``trace``'s
    records): its clustering, KLD weights and aggregation in ms, and the
    device values it read on the host."""
    out = []
    for fed in (r for r in recs if r.name == "huscf.federate"):
        inside = [r for r in recs if fed.t0 <= r.t0 and r.t1 <= fed.t1]

        def ms(name):
            return 1e3 * sum(r.seconds for r in inside if r.name == name)
        reads = sum(r.name == trace.READBACK for r in inside)
        out.append(f"[train] round ({fed.attrs.get('mode')}): cluster "
                   f"{ms('huscf.federate.cluster'):.1f} ms, kld "
                   f"{ms('huscf.federate.kld'):.1f} ms, aggregate "
                   f"{ms('huscf.federate.aggregate'):.1f} ms, {reads} "
                   "readbacks")
    return out


def _train_huscf(args, n_ranks: int):
    import torch.distributed as dist
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.core.latency import PAPER_DEVICES
    from repro_torch.data.partition import build_scenario
    from repro_torch.launch import mesh as mesh_mod

    device, fed_mesh, lead = args.device, None, True
    if n_ranks > 1:
        # one mesh over the ranks; each rank trains on its own GPU (or
        # the CPU), its rows of the step where the groups divide, and
        # every federation round shards over the mesh
        dev_type = torch.device(args.device).type
        fed_mesh = mesh_mod.make_federation_mesh(n_ranks, dev_type)
        device = mesh_mod.rank_device(dev_type)
        lead = dist.get_rank() == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clients = build_scenario(args.scenario, num_clients=args.clients,
                             base_size=args.base_size, seed=args.seed)
    devices = [PAPER_DEVICES[i % 7] for i in range(args.clients)]
    tr = HuSCFTrainer(clients, devices,
                      config=HuSCFConfig(batch=args.batch,
                                         federate_every=args.federate_every,
                                         seed=args.seed,
                                         use_kernel=args.use_kernel,
                                         fused_epoch=not args.per_step,
                                         cohort_size=args.cohort,
                                         agg_chunk=args.agg_chunk,
                                         reoptimize_every=(
                                             args.reoptimize_every)),
                      device=device, fed_mesh=fed_mesh)
    agg = (f"chunked({args.agg_chunk})" if args.agg_chunk else "dense")
    part = (f"cohort {args.cohort}/{args.clients}" if args.cohort
            else "full participation")
    reopt = (f", re-cut every {args.reoptimize_every} rounds"
             if args.reoptimize_every else "")
    say = print if lead else (lambda *a, **k: None)
    say(f"[train] GA latency model: {tr.ga_latency:.2f}s/iter, "
        f"{len(tr.groups)} profile groups, mesh={n_ranks}dev, "
        f"step={'sharded' if tr.step_sharded else 'replicated'}, "
        f"{'per-step' if args.per_step else 'fused'} epochs, "
        f"{agg} aggregation, {part}{reopt}")
    for ep in range(args.epochs):
        since = time.perf_counter_ns()
        m = tr.train_epoch()
        recs = [r for r in trace.records() if r.t0 >= since]
        steps_s = sum(r.seconds for r in recs
                      if r.name == "huscf.train_steps")
        say(f"[train] epoch {ep + 1}: loss_d={m['loss_d']:.3f} "
            f"loss_g={m['loss_g']:.3f} ({steps_s:.1f}s)", flush=True)
        for line in round_lines(recs):
            say(line, flush=True)
    if args.ckpt:
        # a collective on a mesh: every rank gathers, rank 0 writes
        tr.save_checkpoint(args.ckpt)
        say(f"[train] checkpoint -> {args.ckpt}")
    return tr


def lm_batch(cfg, toks: np.ndarray, labs: np.ndarray, i: int, device
             ) -> dict:
    """Step ``i``'s batch on ``device``: tokens and labels, plus the VLM's
    patch embeddings or the encoder's frames from ``default_rng(i)``;
    an encoder-decoder's text is cut to ``max_target_len``."""
    B = toks.shape[0]
    batch = {"tokens": toks, "labels": labs}
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = np.random.default_rng(i).normal(
            0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = np.random.default_rng(i).normal(
            0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
        batch["tokens"] = toks[:, :cfg.max_target_len]
        batch["labels"] = labs[:, :cfg.max_target_len]
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_lm(args, params=None):
    """Centralized LM training; returns (cfg, params, opt_state, the
    per-step losses as 0-dim device tensors). ``params`` starts from
    given weights instead of the seeded draw."""
    from repro_torch import resolve_device
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tokens import lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adam
    from repro_torch.optim.schedules import warmup_cosine

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = T.init_lm(cfg, gen, device)
    opt = adam(warmup_cosine(args.lr, 10, max(args.steps, 20)),
               grad_clip=1.0)
    train_step, opt_init = T.make_train_step(cfg, opt)
    opt_state = opt_init(params)
    batches = lm_batches(cfg.vocab, args.batch, args.seq, seed=args.seed)
    losses = []
    for i in range(args.steps):
        toks, labs = next(batches)
        batch = lm_batch(cfg, toks, labs, i, device)
        t0 = time.time()
        params, opt_state, m = train_step(params, opt_state, batch)
        losses.append(m["loss"])
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"[train] step {i}: loss={float(m['loss']):.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print(f"[train] checkpoint -> {args.ckpt}")
    return cfg, params, opt_state, losses


def main(argv=None, params=None):
    """Parse ``argv`` and train; returns the GAN trainer, or ``train_lm``'s
    result for an LM (``params``: the LM's starting weights)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scenario", default="2dom_noniid")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--base-size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--federate-every", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (LM trainer only)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the LM to this many layers (default: the "
                         "config's depth)")
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="hand-written CUDA kernels for aggregation and "
                         "k-means assignment (default on)")
    ap.add_argument("--fed-devices", type=int, default=None,
                    help="ranks to shard every federation round's client "
                         "rows over (default: every visible GPU on cuda, "
                         "1 on the CPU)")
    ap.add_argument("--per-step", action="store_true",
                    help="per-step epochs (the oracle loop) instead of "
                         "fused ones")
    ap.add_argument("--cohort", type=int, default=None,
                    help="sample this many clients per federation round "
                         "(default: full participation)")
    ap.add_argument("--agg-chunk", type=int, default=None,
                    help="stream aggregation in client chunks of this "
                         "size instead of the dense [K, D] buffer")
    ap.add_argument("--reoptimize-every", type=int, default=None,
                    help="re-run the GA cut search every this many "
                         "federation rounds (default: static cuts)")
    ap.add_argument("--ckpt", default=None,
                    help="write the final state to this checkpoint file")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    if args.arch != "huscf-gan":
        return train_lm(args, params)
    return train_huscf_gan(args)


if __name__ == "__main__":
    main()
