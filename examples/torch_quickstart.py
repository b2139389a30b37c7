"""Quickstart on the PyTorch port: HuSCF-GAN end to end.

The twin of ``examples/quickstart.py``: trains the paper's
split-federated cGAN on a small two-domain non-IID population (6
clients, base size 96, 4 epochs with a FedAvg warm-up round every 2),
runs a clustered federation round, and evaluates generation quality
with the paper's metrics (a CNN trained on generated images, scored on
real gratings; the dataset score of the generated images).

    python examples/torch_quickstart.py                 # on the card
    python examples/torch_quickstart.py --device cpu

``--device`` defaults to ``cuda``; asking for it on a machine without
CUDA raises. ``main(argv)`` returns what it printed.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer  # noqa: E402
from repro_torch.core.latency import PAPER_DEVICES  # noqa: E402
from repro_torch.data.partition import build_scenario  # noqa: E402
from repro_torch.data.synthetic import make_class_balanced  # noqa: E402
from repro_torch.metrics import dataset_score, evaluate  # noqa: E402
from repro_torch.models.classifier import (  # noqa: E402
    predict, predict_proba, train_classifier)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--base-size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n-gen", type=int, default=300,
                    help="generated images the CNN trains on")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. a heterogeneous population: 2 domains, non-IID
    clients = build_scenario("2dom_noniid", num_clients=args.clients,
                             base_size=args.base_size, seed=0)
    devices = [PAPER_DEVICES[i % 7] for i in range(args.clients)]

    # 2. the five-stage HuSCF pipeline (GA cuts -> split training ->
    #    clustering -> KLD federation)
    tr = HuSCFTrainer(clients, devices,
                      config=HuSCFConfig(batch=args.batch, federate_every=2,
                                         seed=0),
                      device=args.device)
    print(f"GA-selected cuts give latency-model {tr.ga_latency:.2f} s/iter "
          f"across {len(tr.groups)} device-profile groups")
    losses = []
    for epoch in range(args.epochs):
        m = tr.train_epoch()
        losses.append(m)
        print(f"epoch {epoch + 1}: loss_d={m['loss_d']:.3f} "
              f"loss_g={m['loss_g']:.3f}")
    diag = tr.federate()
    k, sil = int(diag.get("k", 1)), float(diag.get("silhouette", 0.0))
    print(f"{diag['mode']} federation: k={k} silhouette={sil:.3f}")

    # 3. evaluate: a classifier trained purely on generated data
    labels = np.arange(args.n_gen) % 10
    gen_imgs, gen_labs = tr.generate(8, labels)
    clf = train_classifier(torch.Generator().manual_seed(1), gen_imgs,
                           gen_labs, epochs=3, device=args.device)
    test_i, test_l = make_class_balanced("gratings", 20, seed=9)
    rep = evaluate(test_l, predict(clf, test_i))
    score = dataset_score(predict_proba(clf, gen_imgs))
    print(f"classifier-on-generated: {rep}")
    print(f"dataset score: {score:.2f}")
    return {"ga_latency": tr.ga_latency, "groups": len(tr.groups),
            "losses": losses, "rounds": [d["mode"] for d in tr.fed_log],
            "k": k, "silhouette": sil, "accuracy": rep.accuracy,
            "f1": rep.f1, "fpr": rep.fpr, "score": score}


if __name__ == "__main__":
    main()
