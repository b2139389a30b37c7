"""PFL-GAN (Wijesinghe et al., 2023) — personalized federated GANs
(port of ``repro.baselines.pfl_gan``).

Each client trains a full local cGAN. Periodically the server collects
the local generators, synthesizes data from each, embeds it with a
pre-trained encoder, measures pairwise client similarity via KLD of the
embedding distributions, and builds *refined* per-client synthetic
datasets from similar clients. Each client then continues training on
(local real) + (refined synthetic from similar peers).

Note: this shares GAN-generated samples with the server — exactly the
data-sharing weakness Table 1 attributes to it; the reference reproduces
that behaviour on purpose for comparison, and so does the port. The
synthesis runs on the device; the encoder, the KLDs and the refined
pools are host numpy, as in the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.baselines.common import (BaselineConfig, PopulationTrainer,
                                          gen_forward_dict)
from repro_torch.core.kld import kl_divergence, softmax_np


class PFLGANTrainer(PopulationTrainer):
    name = "pfl_gan"

    def __init__(self, clients, config: BaselineConfig = BaselineConfig(),
                 sim_threshold: float = 0.35, synth_per_round: int = 64,
                 device="cuda"):
        super().__init__(clients, config, device)
        self.sim_threshold = sim_threshold
        self.synth_per_round = synth_per_round
        # refined synthetic pools per client
        self._synth_imgs: List[np.ndarray] = [None] * self.K
        self._synth_labs: List[np.ndarray] = [None] * self.K

    def _encode(self, imgs: np.ndarray) -> np.ndarray:
        """Cheap fixed 'pre-trained encoder': downsampled pixel histogram
        embedding (offline stand-in for their pretrained encoder)."""
        pooled = imgs.reshape(imgs.shape[0], 7, 4, 7, 4).mean((2, 4))
        return pooled.reshape(imgs.shape[0], -1)

    def federate(self) -> None:
        n = self.synth_per_round
        # 1. server synthesizes from every client's G
        z = self._latents(n)
        y = self._fake_labels(n)
        with torch.no_grad():
            synth, _ = gen_forward_dict(self.g_params, self._tensor(z),
                                        self._tensor(y), False)
        synth = synth.cpu().numpy()                  # [K, n, 28, 28, 1]
        # 2. embedding distributions + pairwise KLD
        dists = []
        for k in range(self.K):
            emb = self._encode(synth[k])
            dists.append(softmax_np(emb.mean(0)))
        sim = np.zeros((self.K, self.K))
        for i in range(self.K):
            for j in range(self.K):
                if i != j:
                    sim[i, j] = 0.5 * (kl_divergence(dists[i], dists[j])
                                       + kl_divergence(dists[j], dists[i]))
        # 3. refined datasets: pool synthetic data from similar clients
        for k in range(self.K):
            peers = [j for j in range(self.K)
                     if j != k and sim[k, j] < self.sim_threshold]
            if not peers:
                continue
            self._synth_imgs[k] = np.concatenate([synth[j] for j in peers])
            self._synth_labs[k] = np.concatenate([y[j] for j in peers])

    def _sample_batch(self):
        b = self.cfg.batch
        imgs, ys = [], []
        for k, c in enumerate(self.clients):
            if self._synth_imgs[k] is not None and self._rng.random() < 0.3:
                pool_i, pool_l = self._synth_imgs[k], self._synth_labs[k]
                idx = self._rng.integers(0, pool_i.shape[0], b)
                imgs.append(pool_i[idx]); ys.append(pool_l[idx])
            else:
                idx = self._rng.integers(0, c.n, b)
                imgs.append(c.images[idx]); ys.append(c.labels[idx])
        z = self._latents(b)
        fy = self._fake_labels(b)
        return tuple(self._tensor(a) for a in (np.stack(imgs), np.stack(ys),
                                               z, fy))
