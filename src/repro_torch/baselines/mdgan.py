"""MD-GAN (Hardy et al., 2019), port of ``repro.baselines.mdgan``.

Single generator on the server; one discriminator per client. Each
iteration the server generates two synthetic batches per client (X_d to
train D, X_g to compute G feedback); each client updates its local D and
returns the generator-loss gradients; the server averages them.
Discriminators are periodically swapped between clients.

The server G is one network (K = 1) run over all ``K * b`` rows; the
client discriminators are the population's stacked ``[K, ...]`` D.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.baselines.common import (BaselineConfig, PopulationTrainer,
                                          _as_dict, disc_forward_dict,
                                          gen_forward_dict, generate_single)
from repro_torch.core.huscf import merge_bn, value_and_grad
from repro_torch.models import gan
from repro_torch.models.gan import Z_DIM
from repro_torch.optim.optimizers import AdamState, adam
from repro_torch.tree import tree_map


class MDGANTrainer(PopulationTrainer):
    name = "mdgan"

    def __init__(self, clients, config: BaselineConfig = BaselineConfig(),
                 device="cuda"):
        super().__init__(clients, config, device)
        # single server generator replaces the population of generators
        self.g_server = _as_dict(gan.init_generator(
            torch.Generator().manual_seed(config.seed + 17), self.device))
        opt_init_g, self._upd_g2 = adam(config.lr, b1=config.adam_b1)
        self.opt_gs = opt_init_g(self.g_server)

    def _step(self, batch):
        real_img, real_y, z_d, z_g, fake_y = batch
        K, b = real_img.shape[0], real_img.shape[1]

        # server generates (no grad into G for the D update)
        with torch.no_grad():
            fake_d, _ = gen_forward_dict(self.g_server,
                                         z_d.reshape(1, -1, Z_DIM),
                                         fake_y.reshape(1, -1), True)
        fake_d = fake_d.reshape(K, b, 28, 28, 1)

        # every client's D step: the sum of the clients' losses gives each
        # its own gradient (see ``local_gan_step``)
        def d_loss(dp):
            lr_, nd = disc_forward_dict(dp, real_img, real_y, True)
            lf_, _ = disc_forward_dict(dp, fake_d, fake_y, True)
            return K * gan.d_loss_fn(lr_, lf_), nd

        loss_d, d_bn, grads_d = value_and_grad(d_loss, self.d_params)
        self.opt_d, d_new = self._upd_d(self.opt_d, grads_d, self.d_params)
        self.d_params = merge_bn(d_new, d_bn)

        # generator feedback: mean G loss across client discriminators
        def g_loss(gs):
            fake_g, ng = gen_forward_dict(gs, z_g.reshape(1, -1, Z_DIM),
                                          fake_y.reshape(1, -1), True)
            logits, _ = disc_forward_dict(
                self.d_params, fake_g.reshape(K, b, 28, 28, 1), fake_y, True)
            return gan.g_loss_fn(logits.reshape(-1)), ng

        loss_g, g_bn, grads_g = value_and_grad(g_loss, self.g_server)
        self.opt_gs, g_new = self._upd_g2(self.opt_gs, grads_g,
                                          self.g_server)
        self.g_server = merge_bn(g_new, g_bn)
        return loss_d / K, loss_g

    def train_steps(self, n: int) -> Dict[str, float]:
        loss_d = loss_g = 0.0
        for _ in range(n):
            imgs, ys = self._real_batch()
            z_d = self._latents(self.cfg.batch)
            z_g = self._latents(self.cfg.batch)
            fy = self._fake_labels(self.cfg.batch)
            ld, lg = self._step(tuple(self._tensor(a)
                                      for a in (imgs, ys, z_d, z_g, fy)))
            loss_d, loss_g = float(ld), float(lg)
        return {"loss_d": loss_d, "loss_g": loss_g}

    def federate(self) -> None:
        # MD-GAN swaps discriminators between clients (anti-overfitting);
        # Adam's moments travel with them, its step is shared
        perm = self._tensor(self._rng.permutation(self.K))
        take = lambda x: x[perm]                       # noqa: E731
        self.d_params = tree_map(take, self.d_params)
        self.opt_d = AdamState(self.opt_d.step, tree_map(take, self.opt_d.mu),
                               tree_map(take, self.opt_d.nu))

    def generate(self, n_per_client_batch: int, labels: np.ndarray):
        return generate_single(self.g_server, self._rng, labels, self.device)
