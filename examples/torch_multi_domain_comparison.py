"""The paper's headline comparison on the PyTorch port (Tables 8-10
analogue): HuSCF-GAN against FedGAN and MD-GAN on a two-domain non-IID
population, with classifier metrics, dataset scores, FID and the
analytic latency model side by side.

The twin of ``examples/multi_domain_comparison.py`` (8 clients on
``PAPER_DEVICES[i % 7]``, base size 128, batch 16, a federation every
2 epochs, 6 epochs), scored by ``repro_torch.launch.quality
.evaluate_trainer``:

    python examples/torch_multi_domain_comparison.py [--epochs 6]
    python examples/torch_multi_domain_comparison.py --device cpu \\
        --clients 4 --base-size 24 --epochs 1 --n-gen 60

``--device`` defaults to ``cuda``; asking for it on a machine without
CUDA raises. ``main(argv)`` returns the rows it printed.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.baselines import (BaselineConfig, FedGANTrainer,  # noqa: E402
                                   MDGANTrainer)
from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer  # noqa: E402
from repro_torch.core.latency import (PAPER_DEVICES,  # noqa: E402
                                      fedgan_iteration_latency,
                                      mdgan_iteration_latency)
from repro_torch.data.partition import build_scenario  # noqa: E402
from repro_torch.launch.quality import evaluate_trainer  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--base-size", type=int, default=128)
    ap.add_argument("--n-gen", type=int, default=600,
                    help="generated images each evaluation's CNN trains on")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    clients = build_scenario("2dom_noniid", num_clients=args.clients,
                             base_size=args.base_size, seed=0)
    devices = [PAPER_DEVICES[i % 7] for i in range(args.clients)]
    base = BaselineConfig(batch=16, federate_every=2, seed=0)
    trainers = {
        "HuSCF-GAN": HuSCFTrainer(clients, devices,
                                  config=HuSCFConfig(batch=16,
                                                     federate_every=2,
                                                     seed=0),
                                  device=args.device),
        "FedGAN": FedGANTrainer(clients, base, device=args.device),
        "MD-GAN": MDGANTrainer(clients, base, device=args.device),
    }
    latency = {
        "HuSCF-GAN": trainers["HuSCF-GAN"].ga_latency,
        "FedGAN": fedgan_iteration_latency(devices, 16),
        "MD-GAN": mdgan_iteration_latency(devices, batch=16),
    }
    print(f"{'algo':12s} {'dom':9s} {'acc':>6s} {'f1':>6s} {'score':>6s} "
          f"{'fid':>8s} {'latency-model':>14s}")
    rows = {}
    for name, tr in trainers.items():
        for _ in range(args.epochs):
            tr.train_epoch()
        res = evaluate_trainer(tr, ["gratings", "blobs"], n_gen=args.n_gen,
                               device=args.device)
        rows[name] = {"latency_model_s": latency[name], "metrics": res}
        for dom, m in res.items():
            print(f"{name:12s} {dom:9s} {m['accuracy']*100:5.1f}% "
                  f"{m['f1']*100:5.1f}% {m['score']:6.2f} {m['fid']:8.1f} "
                  f"{latency[name]:12.1f}s")
    return rows


if __name__ == "__main__":
    main()
