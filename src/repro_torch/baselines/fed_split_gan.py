"""Federated Split GANs (Kortoçi et al., 2022), port of
``repro.baselines.fed_split_gan``.

Generator on the server. Each client's discriminator is *split* at a
capability-dependent cut: D-head on the client, D-tail shared on the
server. Client D-heads are FedAvg'd every few epochs. Synthetic images
travel server -> client (the privacy weakness the paper calls out).

Simulation: one shared cut (the scheme's median device) so heads stack;
heterogeneous cuts are the HuSCF contribution, not this baseline's.
The heads are the population's stacked D layers ``[0, D_CUT)``; the
server G and the D tail are single networks (K = 1) run over all
``K * b`` rows.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.baselines.common import (BaselineConfig, PopulationTrainer,
                                          _as_dict, fedavg_population,
                                          gen_forward_dict, generate_single)
from repro_torch.core.huscf import merge_bn, value_and_grad
from repro_torch.models import gan
from repro_torch.models.gan import DISC_LAYER_DEFS, Z_DIM
from repro_torch.optim.optimizers import adam

D_CUT = 2  # client holds D layers [0, D_CUT); server the rest


def disc_split(heads: Dict, tail: Dict, img: torch.Tensor, y: torch.Tensor,
               train: bool):
    """heads: stacked [K, ...]; img [K, b, ...]. Returns (logits [K, b],
    new heads, new tail)."""
    x = (img, y)
    new_heads = {}
    for l in range(D_CUT):
        x, new_heads[str(l)] = DISC_LAYER_DEFS[l].apply(heads[str(l)], x,
                                                        train)
    k, b = x.shape[0], x.shape[1]
    x = x.reshape((1, k * b) + x.shape[2:])
    new_tail = {}
    for l in range(D_CUT, len(DISC_LAYER_DEFS)):
        x, new_tail[str(l)] = DISC_LAYER_DEFS[l].apply(tail[str(l)], x, train)
    return x.reshape(k, b), new_heads, new_tail


class FedSplitGANTrainer(PopulationTrainer):
    name = "fed_split_gan"

    def __init__(self, clients, config: BaselineConfig = BaselineConfig(),
                 device="cuda"):
        super().__init__(clients, config, device)
        gen = torch.Generator().manual_seed(config.seed + 31)
        self.g_server = _as_dict(gan.init_generator(gen, self.device))
        # d_params population: keep only head layers stacked
        self.d_heads = {str(l): self.d_params[str(l)] for l in range(D_CUT)}
        self.d_tail = {str(l): DISC_LAYER_DEFS[l].init(1, gen, self.device)
                       for l in range(D_CUT, len(DISC_LAYER_DEFS))}
        og, self._upd_gs = adam(config.lr, b1=config.adam_b1)
        od, self._upd_dh = adam(config.lr, b1=config.adam_b1)
        ot, self._upd_dt = adam(config.lr, b1=config.adam_b1)
        self.opt_gs = og(self.g_server)
        self.opt_dh = od(self.d_heads)
        self.opt_dt = ot(self.d_tail)

    def _step(self, batch):
        real_img, real_y, z, fake_y = batch
        k, b = real_img.shape[0], real_img.shape[1]
        z1, y1 = z.reshape(1, -1, Z_DIM), fake_y.reshape(1, -1)
        with torch.no_grad():
            fake, _ = gen_forward_dict(self.g_server, z1, y1, True)
        fake = fake.reshape(k, b, 28, 28, 1)

        def d_loss(dp):
            lr_, nh, nt = disc_split(dp["heads"], dp["tail"], real_img,
                                     real_y, True)
            lf_, _, _ = disc_split(dp["heads"], dp["tail"], fake, fake_y,
                                   True)
            return (gan.d_loss_fn(lr_.reshape(-1), lf_.reshape(-1)),
                    {"heads": nh, "tail": nt})

        loss_d, bn, grads = value_and_grad(
            d_loss, {"heads": self.d_heads, "tail": self.d_tail})
        self.opt_dh, heads_new = self._upd_dh(self.opt_dh, grads["heads"],
                                              self.d_heads)
        self.opt_dt, tail_new = self._upd_dt(self.opt_dt, grads["tail"],
                                             self.d_tail)
        self.d_heads = merge_bn(heads_new, bn["heads"])
        self.d_tail = merge_bn(tail_new, bn["tail"])

        def g_loss(gs):
            fake, ng = gen_forward_dict(gs, z1, y1, True)
            logits, _, _ = disc_split(self.d_heads, self.d_tail,
                                      fake.reshape(k, b, 28, 28, 1), fake_y,
                                      True)
            return gan.g_loss_fn(logits.reshape(-1)), ng

        loss_g, g_bn, gg = value_and_grad(g_loss, self.g_server)
        self.opt_gs, g_new = self._upd_gs(self.opt_gs, gg, self.g_server)
        self.g_server = merge_bn(g_new, g_bn)
        return loss_d, loss_g

    def train_steps(self, n: int) -> Dict[str, float]:
        loss_d = loss_g = 0.0
        for _ in range(n):
            ld, lg = self._step(self._sample_batch())
            loss_d, loss_g = float(ld), float(lg)
        return {"loss_d": loss_d, "loss_g": loss_g}

    def federate(self) -> None:
        self.d_heads = fedavg_population(self.d_heads,
                                         self.sizes.astype(np.float64))

    def generate(self, n_per_client_batch: int, labels: np.ndarray):
        return generate_single(self.g_server, self._rng, labels, self.device)
