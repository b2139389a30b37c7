"""Activation-based KLD scoring — paper §4.5, Eq. (13)-(15), in float32 on
the device (port of the device path of ``repro.core.kld``).

P_k   = softmax(mean middle-layer discriminator activation of client k)
P_j,k = leave-one-out mean of P over client k's cluster
KLD_k = KL(P_k || P_j,k)
s_k   = softmax over k's cluster of (log n_k - beta KLD_k)

Eq. (15) is computed in log space: the literal ``n_k exp(-beta KLD_k)``
underflows at the paper's beta = 150.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def cluster_klds(P: torch.Tensor, labels: torch.Tensor, num_clusters: int,
                 eps: float = 1e-12) -> torch.Tensor:
    """Eq. (14) leave-one-out cluster mean + Eq. (2) KLD per client;
    singleton clusters score 0."""
    lab = labels.long()
    onehot = F.one_hot(lab, num_clusters).to(P.dtype)            # [K, C]
    counts = onehot.sum(0)
    csum = onehot.T @ P                                           # [C, F]
    own = counts[lab]
    loo = (csum[lab] - P) / torch.clamp_min(own - 1.0, 1.0)[:, None]
    p = torch.clamp_min(P, eps)
    q = torch.clamp_min(loo, eps)
    kld = torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1)
    return torch.where(own > 1, kld, torch.zeros_like(kld))


def federation_weights(klds: torch.Tensor, sizes: torch.Tensor,
                       labels: torch.Tensor, num_clusters: int,
                       beta: float = 150.0) -> torch.Tensor:
    """Eq. (15): within-cluster log-space softmax of log n_k - beta
    KLD_k. Weights sum to 1 within each cluster."""
    lab = labels.long()
    onehot = F.one_hot(lab, num_clusters).float()
    logits = (torch.log(torch.clamp_min(sizes.float(), 1e-30))
              - beta * klds.float())
    seg_max = torch.where(onehot > 0, logits[:, None],
                          torch.full_like(onehot, -float("inf"))).max(0).values
    e = torch.exp(logits - seg_max[lab])
    denom = onehot.T @ e
    return e / denom[lab]


def activation_weights(acts: torch.Tensor, sizes: torch.Tensor,
                       labels: torch.Tensor, num_clusters: int,
                       beta: float = 150.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end Eq. 13-15: returns (intra-cluster weights, klds)."""
    P = torch.softmax(acts.float(), dim=-1)
    klds = cluster_klds(P, labels, num_clusters)
    return federation_weights(klds, sizes, labels, num_clusters, beta), klds
