"""HFL-GAN (Petch et al., 2025) — hierarchical federated GAN (port of
``repro.baselines.hfl_gan``).

Clients are grouped by cosine similarity of their (flattened) generator
updates; FedAvg runs *locally* within groups every round and *globally*
(across group aggregates) every `global_every` rounds. The scheme trains
two generators per client (hence its 2x latency, paper §6.2); we model
the quality-relevant hierarchy with the primary generator and account
for the dual-generator cost in the latency model only.

The grouping is the reference's host path: the generator's leaves are
flattened in the reference's order and layouts (sorted keys, HWIO
kernels), projected with the same fixed ``default_rng(0)`` matrix and
clustered with the host numpy k-means (``kmeans_np``, the reference's
``kmeans``), so one state gives the reference's groups.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines.common import (BaselineConfig, PopulationTrainer,
                                          fedavg_population)
from repro_torch.bridge import leaf_to_numpy
from repro_torch.core.clustering import kmeans_np
from repro_torch.models.nn import tree_weighted_sum
from repro_torch.tree import tree_from_items, tree_items

_EMBED_DIM = 64


class HFLGANTrainer(PopulationTrainer):
    name = "hfl_gan"

    def __init__(self, clients, config: BaselineConfig = BaselineConfig(),
                 n_groups: int = 2, global_every: int = 3, device="cuda"):
        super().__init__(clients, config, device)
        self.n_groups = min(n_groups, self.K)
        self.global_every = global_every
        self._fed_rounds = 0
        self._proj = None

    def _flat_g(self) -> np.ndarray:
        leaves = [leaf_to_numpy(path, x).reshape(self.K, -1)
                  for path, x in tree_items(self.g_params)]
        flat = np.concatenate(leaves, axis=1)
        # project for tractable cosine clustering; the matrix is the
        # reference's fixed draw, made once
        if self._proj is None:
            rng = np.random.default_rng(0)
            self._proj = rng.normal(0, 1, (flat.shape[1], _EMBED_DIM)
                                    ).astype(np.float32)
        emb = flat @ self._proj
        return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)

    def group_labels(self) -> np.ndarray:
        """The clients' groups from their current generators."""
        labels, _, _ = kmeans_np(self._flat_g(), self.n_groups, seed=0)
        return labels

    def federate(self) -> None:
        self._fed_rounds += 1
        labels = self.group_labels()
        # intra-group FedAvg
        for net in ("g_params", "d_params"):
            items = list(tree_items(getattr(self, net)))
            new = [x.clone() for _, x in items]
            for c in np.unique(labels):
                idx = np.flatnonzero(labels == c)
                w = self.sizes[idx].astype(np.float64)
                w = torch.as_tensor(w / w.sum(), dtype=torch.float32,
                                    device=self.device)
                rows = self._tensor(idx)
                for leaf, (_, x) in zip(new, items):
                    avg = tree_weighted_sum(x.index_select(0, rows), w)
                    leaf[rows] = avg.expand((idx.size,) + avg.shape)
            setattr(self, net, tree_from_items(
                (p, leaf) for (p, _), leaf in zip(items, new)))
        # periodic global round
        if self._fed_rounds % self.global_every == 0:
            self.g_params = fedavg_population(
                self.g_params, self.sizes.astype(np.float64))
            self.d_params = fedavg_population(
                self.d_params, self.sizes.astype(np.float64))
