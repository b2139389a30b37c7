"""Shared infrastructure for the baseline distributed-GAN schemes, in
PyTorch (port of ``repro.baselines.common``).

All baselines use the paper's cGAN (Table 3) "to ensure fairness".
The core building block is a *population* of K full local cGANs. The
reference vmaps one client's step over K; here the K clients are the
leading axis of every leaf, so one call of each layer's ``apply`` runs
all of them (a grouped convolution with ``groups=K``), as a HuSCF
profile group does. One Adam over the stacked tree is the reference's
per-client Adam, since Adam is elementwise and every client steps
together. Schemes differ in what is shared or aggregated, and when.

Random draws: the initial weights come from a ``torch.Generator``
(JAX's draws cannot be reproduced; tests carry the reference's weights
over with ``repro_torch.bridge``). Every batch, latent and fake label
comes from ``numpy.random.default_rng(seed + 1)`` on the host, exactly
as in the reference, so one state and one seed give the reference's
batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.huscf import merge_bn, value_and_grad
from repro_torch.data.partition import ClientSpec
from repro_torch.models import gan
from repro_torch.models.gan import Z_DIM
from repro_torch.models.nn import tree_weighted_sum
from repro_torch.optim.optimizers import adam
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class BaselineConfig:
    batch: int = 32
    lr: float = 2e-4
    adam_b1: float = 0.5
    federate_every: int = 5
    seed: int = 0
    steps_per_epoch: Optional[int] = None


def init_population(gen: torch.Generator, k: int, device):
    """K stacked generators and K stacked discriminators, drawn on the
    CPU from ``gen`` and moved to ``device``."""
    gs = _as_dict(gan.init_generator(gen, device, k))
    ds = _as_dict(gan.init_discriminator(gen, device, k))
    return gs, ds


def _as_dict(layers: List[Dict]) -> Dict[str, Dict]:
    return {str(i): p for i, p in enumerate(layers)}


def _as_list(d: Dict[str, Dict]) -> List[Dict]:
    return [d[str(i)] for i in range(len(d))]


def gen_forward_dict(params: Dict, z, y, train: bool):
    out, new = gan.generator_forward(_as_list(params), z, y, train=train)
    return out, _as_dict(new)


def disc_forward_dict(params: Dict, img, y, train: bool):
    out, new = gan.discriminator_forward(_as_list(params), img, y,
                                         train=train)
    return out, _as_dict(new)


def local_gan_step(g_params, d_params, opt_g, opt_d, batch,
                   opt_update_g, opt_update_d):
    """One cGAN step of K stacked clients: ``batch`` holds ``[K, b, ...]``
    tensors. Each client's loss is the mean over its own rows; the
    gradients of their sum, ``K`` times the mean over all rows, are each
    client's own. Returns the clients' mean losses."""
    real_img, real_y, z, fake_y = batch
    K = real_img.shape[0]
    with torch.no_grad():
        fake, _ = gen_forward_dict(g_params, z, fake_y, True)

    def d_loss(dp):
        lr_, nd = disc_forward_dict(dp, real_img, real_y, True)
        lf_, _ = disc_forward_dict(dp, fake, fake_y, True)
        return K * gan.d_loss_fn(lr_, lf_), nd

    loss_d, d_bn, grads_d = value_and_grad(d_loss, d_params)
    opt_d, d_new = opt_update_d(opt_d, grads_d, d_params)
    d_new = merge_bn(d_new, d_bn)

    def g_loss(gp):
        fake, ng = gen_forward_dict(gp, z, fake_y, True)
        logits, _ = disc_forward_dict(d_new, fake, fake_y, True)
        return K * gan.g_loss_fn(logits), ng

    loss_g, g_bn, grads_g = value_and_grad(g_loss, g_params)
    opt_g, g_new = opt_update_g(opt_g, grads_g, g_params)
    g_new = merge_bn(g_new, g_bn)
    return g_new, d_new, opt_g, opt_d, loss_d / K, loss_g / K


class PopulationTrainer:
    """K independent local cGANs, stacked. Base class for baselines."""

    name = "population"

    def __init__(self, clients: Sequence[ClientSpec],
                 config: BaselineConfig = BaselineConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.clients = list(clients)
        self.cfg = config
        self.K = len(self.clients)
        self.sizes = np.array([c.n for c in self.clients], np.int64)
        self.g_params, self.d_params = init_population(
            torch.Generator().manual_seed(config.seed), self.K, self.device)
        opt_init_g, self._upd_g = adam(config.lr, b1=config.adam_b1)
        opt_init_d, self._upd_d = adam(config.lr, b1=config.adam_b1)
        self.opt_g = opt_init_g(self.g_params)
        self.opt_d = opt_init_d(self.d_params)
        self._rng = np.random.default_rng(config.seed + 1)
        self.epoch = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _real_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """b real images and labels per client, drawn with replacement."""
        b = self.cfg.batch
        imgs, ys = [], []
        for c in self.clients:
            idx = self._rng.integers(0, c.n, b)
            imgs.append(c.images[idx])
            ys.append(c.labels[idx])
        return np.stack(imgs), np.stack(ys)

    def _latents(self, n: int) -> np.ndarray:
        return self._rng.normal(0, 1, (self.K, n, Z_DIM)).astype(np.float32)

    def _fake_labels(self, n: int) -> np.ndarray:
        return self._rng.integers(0, gan.NUM_CLASSES, (self.K, n)
                                  ).astype(np.int32)

    def _sample_batch(self):
        imgs, ys = self._real_batch()
        z = self._latents(self.cfg.batch)
        fy = self._fake_labels(self.cfg.batch)
        return tuple(self._tensor(a) for a in (imgs, ys, z, fy))

    def train_steps(self, n: int) -> Dict[str, float]:
        loss_d = loss_g = 0.0
        for _ in range(n):
            batch = self._sample_batch()
            (self.g_params, self.d_params, self.opt_g, self.opt_d,
             ld, lg) = local_gan_step(self.g_params, self.d_params,
                                      self.opt_g, self.opt_d, batch,
                                      self._upd_g, self._upd_d)
            loss_d, loss_g = float(ld), float(lg)
        return {"loss_d": loss_d, "loss_g": loss_g}

    def train_epoch(self) -> Dict[str, float]:
        steps = self.cfg.steps_per_epoch or max(
            1, int(np.median(self.sizes)) // self.cfg.batch)
        m = self.train_steps(steps)
        self.epoch += 1
        if self.epoch % self.cfg.federate_every == 0:
            self.federate()
        return m

    def federate(self) -> None:  # overridden by schemes
        pass

    # -- evaluation ---------------------------------------------------------
    def generate(self, n_per_client_batch: int, labels: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """len(labels) images from every client's G in eval mode, the
        labels spread over the clients in turn."""
        imgs_all, labs_all = [], []
        i = 0
        while i < len(labels):
            need = min(n_per_client_batch,
                       max(1, -(-(len(labels) - i) // self.K)))
            lab = np.resize(labels[i:], (self.K, need)).astype(np.int32)
            z = self._latents(need)
            with torch.no_grad():
                out, _ = gen_forward_dict(self.g_params, self._tensor(z),
                                          self._tensor(lab), False)
            out = out.reshape(-1, 28, 28, 1).cpu().numpy()
            imgs_all.append(out)
            labs_all.append(lab.reshape(-1))
            i += out.shape[0]
        return (np.concatenate(imgs_all)[: len(labels)],
                np.concatenate(labs_all)[: len(labels)])


def generate_single(g_server: Dict, rng: np.random.Generator,
                    labels: np.ndarray, device: torch.device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """len(labels) images from one server G (K = 1) in eval mode, in
    chunks of 256."""
    out_imgs, out_labs, i = [], [], 0
    while i < len(labels):
        take = min(256, len(labels) - i)
        lab = labels[i: i + take].astype(np.int32)
        z = rng.normal(0, 1, (take, Z_DIM)).astype(np.float32)
        with torch.no_grad():
            out, _ = gen_forward_dict(
                g_server, torch.as_tensor(z, device=device)[None],
                torch.as_tensor(lab, device=device)[None], False)
        out_imgs.append(out[0].cpu().numpy())
        out_labs.append(lab)
        i += take
    return np.concatenate(out_imgs), np.concatenate(out_labs)


def fedavg_population(params, weights: np.ndarray):
    """Replace every client copy with the weighted average."""
    w = torch.as_tensor(weights / weights.sum(), dtype=torch.float32,
                        device=tree_leaves(params)[0].device)
    avg = tree_weighted_sum(params, w)
    return tree_map(lambda a, x: a.expand_as(x).clone(), avg, params)
