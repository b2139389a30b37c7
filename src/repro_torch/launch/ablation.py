"""The component ablation and the KLD comparison of HuSCF-GAN (the
port's counterparts of ``benchmarks/ablation_components.py``, paper
Table 23, and ``benchmarks/kld_comparison.py``, paper Table 17).

Table 23 trains three variants on ``2dom_highly_noniid``: KLD weighting
without clustering (``NoClusterTrainer``: one global cluster),
clustering without KLD weights (``NoKLDTrainer``: ``beta = 0`` for the
round, so the weights within a cluster follow the dataset sizes alone)
and both (``HuSCFTrainer``). Table 17 trains on ``1dom_noniid`` with the
private activation-based KLD (``HuSCFTrainer``) and with the FeGAN-style
label-histogram KLD (``LabelKLDTrainer``, which leaks labels). Each run
is the reference's: 6 clients on ``PAPER_DEVICES[i % 7]``, base size
96, batch 16, 4 epochs with a federation every 2, seed 0, the trainer's
default fused epochs, scored by ``launch.quality.evaluate_trainer``.

  PYTHONPATH=src python -m repro_torch.launch.ablation --table 23

prints one JSON line per (table, variant, domain). ``--device`` picks
the device (default ``cuda``; asking for it on a machine without CUDA
raises). Float32 products and convolutions run in full float32: TF32
is switched off.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
from repro_torch.core.latency import PAPER_DEVICES
from repro_torch.data.partition import build_scenario
from repro_torch.launch.quality import (SCENARIO_DOMAINS, _sync,
                                        evaluate_trainer)


class NoClusterTrainer(HuSCFTrainer):
    """KLD weighting only: every clustered round puts all clients in one
    cluster."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.cfg = dataclasses.replace(self.cfg, num_clusters=1)


class NoKLDTrainer(HuSCFTrainer):
    """Clustering only: ``beta = 0`` for the round makes every
    ``exp(-beta KLD)`` 1, so the weights within a cluster follow the
    clients' dataset sizes."""

    def federate(self, use_label_kld: bool = False, **kw):
        old = self.cfg.beta
        self.cfg.beta = 0.0
        try:
            return super().federate(use_label_kld, **kw)
        finally:
            self.cfg.beta = old


class LabelKLDTrainer(HuSCFTrainer):
    """The FeGAN-style label-distribution KLD in every clustered round."""

    def federate(self, use_label_kld: bool = True, **kw):
        return super().federate(use_label_kld=True, **kw)


ABLATION = ("2dom_highly_noniid", "table23", (
    ("kld_only", NoClusterTrainer), ("clustering_only", NoKLDTrainer),
    ("kld_plus_clustering", HuSCFTrainer)))
KLD_COMPARISON = ("1dom_noniid", "table17", (
    ("activation_kld", HuSCFTrainer), ("label_kld", LabelKLDTrainer)))


def _run(spec: Tuple[str, str, Sequence], *, num_clients: int,
         base_size: int, epochs: int, batch: int, seed: int, device
         ) -> Dict[str, Dict]:
    """Train and score each variant of ``spec`` (scenario, table name,
    (variant, trainer class) pairs): per variant the per-domain metrics,
    ``train_s``, ``eval_s`` and ``wall_s``."""
    device = resolve_device(device)
    scenario, _, variants = spec
    clients = build_scenario(scenario, num_clients=num_clients,
                             base_size=base_size, seed=seed)
    devices = [PAPER_DEVICES[i % 7] for i in range(num_clients)]
    results = {}
    for name, cls in variants:
        _sync(device)
        t0 = time.perf_counter()
        tr = cls(clients, devices,
                 config=HuSCFConfig(batch=batch, federate_every=2,
                                    seed=seed), device=device)
        for _ in range(epochs):
            tr.train_epoch()
        _sync(device)
        t1 = time.perf_counter()
        metrics = evaluate_trainer(tr, SCENARIO_DOMAINS[scenario],
                                   device=device)
        t2 = time.perf_counter()
        results[name] = {"metrics": metrics, "train_s": t1 - t0,
                         "eval_s": t2 - t1, "wall_s": t2 - t0,
                         "rounds": [d["mode"] for d in tr.fed_log]}
    return results


def run_ablation(*, num_clients: int = 6, base_size: int = 96,
                 epochs: int = 4, batch: int = 16, seed: int = 0,
                 device="cuda") -> Dict[str, Dict]:
    """Paper Table 23: KLD only, clustering only, both."""
    return _run(ABLATION, num_clients=num_clients, base_size=base_size,
                epochs=epochs, batch=batch, seed=seed, device=device)


def run_kld_comparison(*, num_clients: int = 6, base_size: int = 96,
                       epochs: int = 4, batch: int = 16, seed: int = 0,
                       device="cuda") -> Dict[str, Dict]:
    """Paper Table 17: activation-based against label-based KLD."""
    return _run(KLD_COMPARISON, num_clients=num_clients,
                base_size=base_size, epochs=epochs, batch=batch, seed=seed,
                device=device)


def main(argv=None) -> Dict[str, Dict[str, Dict]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--table", choices=("23", "17", "both"), default="both")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--base-size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(num_clients=args.clients, base_size=args.base_size,
              epochs=args.epochs, batch=args.batch, seed=args.seed,
              device=args.device)
    out = {}
    for table, spec in (("23", ABLATION), ("17", KLD_COMPARISON)):
        if args.table not in (table, "both"):
            continue
        res = out[spec[1]] = _run(spec, **kw)
        for name, r in res.items():
            for dom, m in r["metrics"].items():
                print(json.dumps({"name": f"{spec[1]}/{name}/{dom}",
                                  "wall_s": r["wall_s"], **m}), flush=True)
    return out


if __name__ == "__main__":
    main()
