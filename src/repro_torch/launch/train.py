"""Training launcher of the PyTorch port (huscf-gan mode).

Runs the paper's split-federated GAN over a heterogeneous client
population on one device, with the flags and the printed lines of
``python -m repro.launch.train --arch huscf-gan``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch huscf-gan \
      --epochs 6 --federate-every 2

``--device`` picks the device (default ``cuda``; asking for it on a
machine without CUDA raises). Kernels K1/K2 are on by default
(``--no-use-kernel`` runs their plain expressions). Float32 products
and convolutions run in full float32: TF32 is switched off.
The LM trainer and the flags of paths not ported yet raise.
"""
from __future__ import annotations

import argparse
import time

import torch


def train_huscf_gan(args):
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.core.latency import PAPER_DEVICES
    from repro_torch.data.partition import build_scenario

    unported = {"fed_devices": "M10, mesh code", "ckpt": "M7b, checkpoint",
                "cohort": "M6b, cohorts/registry",
                "agg_chunk": "M6c, chunked stream",
                "reoptimize_every": "M9b, online re-cut"}
    for flag, item in unported.items():
        if getattr(args, flag) not in (None, False, 1):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not "
                                      f"ported yet (ROADMAP {item})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clients = build_scenario(args.scenario, num_clients=args.clients,
                             base_size=args.base_size, seed=args.seed)
    devices = [PAPER_DEVICES[i % 7] for i in range(args.clients)]
    tr = HuSCFTrainer(clients, devices,
                      config=HuSCFConfig(batch=args.batch,
                                         federate_every=args.federate_every,
                                         seed=args.seed,
                                         use_kernel=args.use_kernel),
                      device=args.device)
    print(f"[train] GA latency model: {tr.ga_latency:.2f}s/iter, "
          f"{len(tr.groups)} profile groups, mesh=1dev, eager epochs, "
          f"dense aggregation, full participation")
    for ep in range(args.epochs):
        t0 = time.time()
        m = tr.train_epoch()
        print(f"[train] epoch {ep + 1}: loss_d={m['loss_d']:.3f} "
              f"loss_g={m['loss_g']:.3f} ({time.time() - t0:.1f}s)",
              flush=True)
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
    ap.add_argument("--cohort", type=int, default=None)
    ap.add_argument("--agg-chunk", type=int, default=None)
    ap.add_argument("--reoptimize-every", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    if args.arch != "huscf-gan":
        raise NotImplementedError(f"--arch {args.arch}: the LM trainer is not "
                                  "ported yet (ROADMAP M10)")
    return train_huscf_gan(args)


if __name__ == "__main__":
    main()
