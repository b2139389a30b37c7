"""The paper's technique beyond GANs (§7.3) on the PyTorch port: train
an assigned LM with heterogeneous U-shaped split learning and clustered
KLD federation. Two device profiles (weak and strong) hold heads and
tails of different depths; the trunk is shared on the server.

The twin of ``examples/split_lm_training.py`` (granite-3-2b's smoke
config cut to 6 layers, 2 weak and 2 strong clients, 2 sequences of 32
tokens each per client, 12 iterations at lr 3e-4, one federation round
of two clusters after iteration 7). Each group's token stream is seeded
from a CRC-32 of its name, where the reference takes the process's
string hash, which changes from run to run.

    python examples/torch_split_lm_training.py
    python examples/torch_split_lm_training.py --device cpu

``--device`` defaults to ``cuda``; asking for it on a machine without
CUDA raises. ``main(argv)`` returns the losses it printed.
"""
import argparse
import dataclasses
import os
import sys
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.split_transformer import (  # noqa: E402
    default_groups, federate_split_lm, init_split_lm, make_split_train_step)
from repro_torch.data.tokens import lm_batches  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), n_layers=6)
    groups = default_groups(cfg, n_weak=2, n_strong=2)
    params = init_split_lm(cfg, groups,
                           torch.Generator(device=device).manual_seed(0),
                           device)
    step, opt_init = make_split_train_step(cfg, groups, lr=3e-4)
    opt = opt_init(params)

    gens = {g.name: lm_batches(cfg.vocab, g.n_clients * 2, 32,
                               seed=zlib.crc32(g.name.encode()) % 1000)
            for g in groups}
    print("population: " + ", ".join(
        f"{g.name}(K={g.n_clients}, head={g.cut_head}, tail={g.cut_tail})"
        for g in groups))
    losses, federated_at = [], None
    for it in range(args.iters):
        batch = {"tokens": {}, "labels": {}}
        for g in groups:
            toks, labs = next(gens[g.name])
            batch["tokens"][g.name] = torch.as_tensor(
                toks.reshape(g.n_clients, 2, 32), device=device)
            batch["labels"][g.name] = torch.as_tensor(
                labs.reshape(g.n_clients, 2, 32), device=device)
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
        if it % 3 == 0:
            print(f"iter {it}: loss={float(m['loss']):.4f}")
        if it == 7:  # a federation round (uniform weights, 2 clusters)
            params = federate_split_lm(params, groups, np.full(4, 0.5),
                                       np.array([0, 0, 1, 1]))
            federated_at = it
            print("federated client segments (2 clusters)")
    losses = [float(x) for x in losses]
    print(f"final loss: {losses[-1]:.4f}")
    return {"losses": losses, "federated_at": federated_at,
            "groups": [(g.name, g.n_clients, g.cut_head, g.cut_tail)
                       for g in groups]}


if __name__ == "__main__":
    main()
