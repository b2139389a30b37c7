"""Quality of HuSCF-GAN against the baselines, per scenario (the port's
counterpart of ``benchmarks/quality_scenarios.py``, paper Tables 6-13
on the synthetic multi-domain data).

For each algorithm: train for some epochs, generate 600 images, train
the evaluation CNN on them and score it on real per-domain test sets
(accuracy, macro F1 and FPR), and score the images with a per-domain
classifier trained on real data (dataset score, FID on its penultimate
features). The sizes and the classifiers' seeds (7 and 8, here
``torch.Generator`` seeds) are the reference's.

  PYTHONPATH=src python -m repro_torch.launch.quality \
      --scenario 2dom_noniid --algos huscf,fedgan,mdgan

prints one JSON line per (scenario, algorithm, domain). ``--device``
picks the device (default ``cuda``; asking for it on a machine without
CUDA raises). Float32 products and convolutions run in full float32:
TF32 is switched off.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.baselines import ALL_BASELINES, BaselineConfig
from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
from repro_torch.core.latency import PAPER_DEVICES
from repro_torch.data.partition import build_scenario
from repro_torch.data.synthetic import make_class_balanced
from repro_torch.metrics import dataset_score, evaluate, fid
from repro_torch.models.classifier import (features, predict, predict_proba,
                                           train_classifier)


def evaluate_trainer(tr, domains: List[str], n_gen: int = 600,
                     seed: int = 0, device="cuda"
                     ) -> Dict[str, Dict[str, float]]:
    """Train a CNN on generated data, evaluate on real per-domain test
    sets; also dataset score + FID vs per-domain scoring classifiers."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n_gen).astype(np.int32)
    gen_imgs, gen_labs = tr.generate(8, labels)
    out = {}
    clf_gen = train_classifier(torch.Generator().manual_seed(7), gen_imgs,
                               gen_labs, epochs=4, device=device)
    for dom in domains:
        test_i, test_l = make_class_balanced(dom, 30, seed=123)
        rep = evaluate(test_l, predict(clf_gen, test_i))
        # dataset-specific scoring classifier (trained on real data)
        score_i, score_l = make_class_balanced(dom, 60, seed=5)
        clf_real = train_classifier(torch.Generator().manual_seed(8),
                                    score_i, score_l, epochs=4,
                                    device=device)
        gen_score = dataset_score(predict_proba(clf_real, gen_imgs))
        f = fid(features(clf_real, score_i), features(clf_real, gen_imgs))
        out[dom] = {"accuracy": rep.accuracy, "f1": rep.f1,
                    "fpr": rep.fpr, "score": gen_score, "fid": f}
    return out


SCENARIO_DOMAINS = {
    "1dom_iid": ["gratings"], "1dom_noniid": ["gratings"],
    "2dom_iid": ["gratings", "blobs"], "2dom_noniid": ["gratings", "blobs"],
    "2dom_highly_noniid": ["gratings", "blobs"],
    "4dom_iid": ["gratings", "blobs", "checkers", "rings"],
    "2dom_medical": ["rings", "checkers"],
    "2dom_highres": ["checkers", "blobs"],
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_scenario(scenario: str, *, num_clients: int = 6,
                 base_size: int = 96, epochs: int = 4, batch: int = 16,
                 algos: Sequence[str] = ("huscf", "fedgan", "mdgan"),
                 seed: int = 0, device="cuda") -> Dict[str, Dict]:
    """Per algorithm: ``metrics`` (per domain), ``wall_s`` (training and
    evaluation), ``train_s``, ``eval_s``, ``epochs``, ``steps`` and
    ``s_per_step`` (training seconds over steps, rounds included)."""
    device = resolve_device(device)
    clients = build_scenario(scenario, num_clients=num_clients,
                             base_size=base_size, seed=seed)
    devices = [PAPER_DEVICES[i % 7] for i in range(num_clients)]
    domains = SCENARIO_DOMAINS[scenario]
    results = {}
    for algo in algos:
        _sync(device)
        t0 = time.perf_counter()
        if algo == "huscf":
            tr = HuSCFTrainer(clients, devices,
                              config=HuSCFConfig(batch=batch,
                                                 federate_every=2, seed=seed),
                              device=device)
        else:
            tr = ALL_BASELINES[algo](clients, BaselineConfig(
                batch=batch, federate_every=2, seed=seed), device=device)
        for _ in range(epochs):
            tr.train_epoch()
        _sync(device)
        t1 = time.perf_counter()
        metrics = evaluate_trainer(tr, domains, device=device)
        t2 = time.perf_counter()
        steps = epochs * (tr.cfg.steps_per_epoch or max(
            1, int(np.median(tr.sizes)) // tr.cfg.batch))
        results[algo] = {"metrics": metrics, "wall_s": t2 - t0,
                         "train_s": t1 - t0, "eval_s": t2 - t1,
                         "epochs": epochs, "steps": steps,
                         "s_per_step": (t1 - t0) / steps}
    return results


def main(argv=None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenario", default="2dom_noniid",
                    choices=sorted(SCENARIO_DOMAINS))
    ap.add_argument("--algos", default="huscf,fedgan,mdgan",
                    help="comma-separated: huscf and any of "
                         + ", ".join(sorted(ALL_BASELINES)))
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--base-size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    algos = [a for a in args.algos.split(",") if a]
    unknown = [a for a in algos if a != "huscf" and a not in ALL_BASELINES]
    if unknown:
        ap.error(f"unknown algorithms {unknown}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run_scenario(args.scenario, num_clients=args.clients,
                       base_size=args.base_size, epochs=args.epochs,
                       batch=args.batch, algos=algos, seed=args.seed,
                       device=args.device)
    for algo, r in res.items():
        for dom, m in r["metrics"].items():
            print(json.dumps({"name": f"quality/{args.scenario}/{algo}/{dom}",
                              "wall_s": r["wall_s"], **m}), flush=True)
    return res


if __name__ == "__main__":
    main()
