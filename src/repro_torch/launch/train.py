"""Training launcher of the PyTorch port (huscf-gan mode).

Runs the paper's split-federated GAN over a heterogeneous client
population on one device, with the flags and the printed lines of
``python -m repro.launch.train --arch huscf-gan``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch huscf-gan \
      --epochs 6 --federate-every 2

``--device`` picks the device (default ``cuda``; asking for it on a
machine without CUDA raises). Kernels K1/K2 are on by default
(``--no-use-kernel`` runs their plain expressions). Float32 products
and convolutions run in full float32: TF32 is switched off. Epochs run
step by step, as the reference's ``--per-step`` runs them; the flag is
accepted and changes nothing.

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

The LM trainer and ``--fed-devices`` (ROADMAP M10) raise.
"""
from __future__ import annotations

import argparse
import time

import torch


def train_huscf_gan(args):
    from repro_torch.bridge import state_to_numpy
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.core.latency import PAPER_DEVICES
    from repro_torch.data.partition import build_scenario

    if args.fed_devices not in (None, 1):
        raise NotImplementedError("--fed-devices is not ported yet (ROADMAP "
                                  "M10, mesh code)")
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
                                         cohort_size=args.cohort,
                                         agg_chunk=args.agg_chunk,
                                         reoptimize_every=(
                                             args.reoptimize_every)),
                      device=args.device)
    agg = (f"chunked({args.agg_chunk})" if args.agg_chunk else "dense")
    part = (f"cohort {args.cohort}/{args.clients}" if args.cohort
            else "full participation")
    reopt = (f", re-cut every {args.reoptimize_every} rounds"
             if args.reoptimize_every else "")
    print(f"[train] GA latency model: {tr.ga_latency:.2f}s/iter, "
          f"{len(tr.groups)} profile groups, mesh=1dev, per-step epochs, "
          f"{agg} aggregation, {part}{reopt}")
    for ep in range(args.epochs):
        t0 = time.time()
        m = tr.train_epoch()
        print(f"[train] epoch {ep + 1}: loss_d={m['loss_d']:.3f} "
              f"loss_g={m['loss_g']:.3f} ({time.time() - t0:.1f}s)",
              flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, state_to_numpy(tr.state), step=tr.epoch)
        print(f"[train] checkpoint -> {args.ckpt}")
    return tr


def main(argv=None):
    """Parse ``argv`` and train; returns the trainer."""
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
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="hand-written CUDA kernels for aggregation and "
                         "k-means assignment (default on)")
    ap.add_argument("--fed-devices", type=int, default=None)
    ap.add_argument("--per-step", action="store_true",
                    help="per-step epochs (the reference's oracle loop); "
                         "the port's epochs run step by step either way")
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
        raise NotImplementedError(f"--arch {args.arch}: the LM trainer is not "
                                  "ported yet (ROADMAP M10)")
    return train_huscf_gan(args)


if __name__ == "__main__":
    main()
