"""Activation-based KLD scoring — paper §4.5, Eq. (13)-(15) (port of
``repro.core.kld``).

P_k   = softmax(mean middle-layer discriminator activation of client k)
P_j,k = leave-one-out mean of P over client k's cluster
KLD_k = KL(P_k || P_j,k)
s_k   = softmax over k's cluster of (log n_k - beta KLD_k)

Eq. (15) is computed in log space: the literal ``n_k exp(-beta KLD_k)``
underflows at the paper's beta = 150.

Two paths of the same chain: the device path in float32 torch (the
trainer's clustered round) and a line-for-line copy of the reference's
host numpy path in float64 (the host round: ``fused_cluster=False`` and
the label-histogram KLD of the FeGAN-style baseline, paper §6.3). The
cohort variants renormalize Eq. 15 over the clients sampled this round
(``core.registry``). Where a name exists on both paths the numpy copy
carries an ``_np`` suffix:

    reference (device / host)        port device (torch)     port host (numpy)
    cluster_klds_jax / cluster_klds  cluster_klds            cluster_klds_np
    federation_weights[_jax]         federation_weights      federation_weights_np
    cohort_federation_weights[_jax]  cohort_federation_weights
                                                             cohort_federation_weights_np
    activation_weights[_jax]         activation_weights      activation_weights_np
    softmax_np, kl_divergence, activation_distributions, global_weights,
    label_weights                    -                       same names
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# host path (numpy, float64)
# ---------------------------------------------------------------------------

def softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def kl_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """Eq. (2)."""
    p = np.clip(p, eps, None)
    q = np.clip(q, eps, None)
    return float(np.sum(p * np.log(p / q)))


def activation_distributions(acts: np.ndarray) -> np.ndarray:
    """Eq. (13): P_k = softmax(alpha_k)."""
    return softmax_np(acts.astype(np.float64), axis=-1)


def cluster_klds_np(P: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Eq. (14) leave-one-out cluster mean + Eq. (2) KLD per client."""
    K = P.shape[0]
    klds = np.zeros(K)
    for k in range(K):
        same = np.flatnonzero(labels == labels[k])
        others = same[same != k]
        if others.size == 0:
            klds[k] = 0.0
            continue
        P_j = P[others].sum(0) / others.size
        klds[k] = kl_divergence(P[k], P_j)
    return klds


def _logits(klds: np.ndarray, sizes: np.ndarray, beta: float) -> np.ndarray:
    """log n_k - beta KLD_k, the log of Eq. 15's unnormalized s_k."""
    return (np.log(np.maximum(sizes.astype(np.float64), 1e-300))
            - beta * np.asarray(klds, np.float64))


def _softmax_masked(logits: np.ndarray, mask: np.ndarray) -> np.ndarray:
    l = logits[mask]
    e = np.exp(l - l.max())
    return e / e.sum()


def federation_weights_np(klds: np.ndarray, sizes: np.ndarray,
                          labels: np.ndarray, beta: float = 150.0
                          ) -> np.ndarray:
    """Eq. (15): within-cluster normalized s_k, as a log-space softmax of
    ``log n_k - beta KLD_k`` per cluster. [K] weights that sum to 1
    within each cluster."""
    logits = _logits(klds, sizes, beta)
    out = np.zeros_like(logits)
    for c in np.unique(labels):
        mask = labels == c
        out[mask] = _softmax_masked(logits, mask)
    return out


def global_weights(klds: np.ndarray, sizes: np.ndarray,
                   beta: float = 150.0) -> np.ndarray:
    """Eq. (15) applied globally (server-side segments, paper §4.5 end)."""
    logits = _logits(klds, sizes, beta)
    return _softmax_masked(logits, np.ones(len(logits), bool))


def cohort_federation_weights_np(klds: np.ndarray, sizes: np.ndarray,
                                 labels: np.ndarray, cohort: np.ndarray,
                                 beta: float = 150.0) -> np.ndarray:
    """Eq. (15) renormalized over a sampled cohort: within each cluster
    the softmax runs over the cohort members only, so their weights sum
    to 1 per (cluster ∩ cohort) and every non-member gets exactly 0.
    ``cohort``: [K] bool participation mask."""
    logits = _logits(klds, sizes, beta)
    cohort = np.asarray(cohort, bool)
    out = np.zeros_like(logits)
    for c in np.unique(labels[cohort]):
        mask = (labels == c) & cohort
        out[mask] = _softmax_masked(logits, mask)
    return out


def activation_weights_np(acts: np.ndarray, sizes: np.ndarray,
                          labels: np.ndarray, beta: float = 150.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end Eq. 13-15: returns (intra-cluster weights, klds)."""
    P = activation_distributions(acts)
    klds = cluster_klds_np(P, labels)
    return federation_weights_np(klds, sizes, labels, beta), klds


def label_weights(label_hists: np.ndarray, sizes: np.ndarray,
                  labels: np.ndarray, beta: float = 150.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """FeGAN-style label-distribution KLD (privacy-leaking baseline,
    paper §6.3). label_hists: [K, num_classes] counts."""
    P = label_hists.astype(np.float64)
    P = P / np.clip(P.sum(-1, keepdims=True), 1e-12, None)
    klds = cluster_klds_np(P, labels)
    return federation_weights_np(klds, sizes, labels, beta), klds


# ---------------------------------------------------------------------------
# device path (torch, float32)
# ---------------------------------------------------------------------------

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


def _device_logits(klds: torch.Tensor, sizes: torch.Tensor,
                   beta: float) -> torch.Tensor:
    return (torch.log(torch.clamp_min(sizes.float(), 1e-30))
            - beta * klds.float())


def federation_weights(klds: torch.Tensor, sizes: torch.Tensor,
                       labels: torch.Tensor, num_clusters: int,
                       beta: float = 150.0) -> torch.Tensor:
    """Eq. (15): within-cluster log-space softmax of log n_k - beta
    KLD_k. Weights sum to 1 within each cluster."""
    lab = labels.long()
    onehot = F.one_hot(lab, num_clusters).float()
    logits = _device_logits(klds, sizes, beta)
    seg_max = torch.where(onehot > 0, logits[:, None],
                          torch.full_like(onehot, -float("inf"))).max(0).values
    e = torch.exp(logits - seg_max[lab])
    denom = onehot.T @ e
    return e / denom[lab]


def cohort_federation_weights(klds: torch.Tensor, sizes: torch.Tensor,
                              labels: torch.Tensor, cohort_mask: torch.Tensor,
                              num_clusters: int, beta: float = 150.0
                              ) -> torch.Tensor:
    """Eq. (15) renormalized over the cohort: within-cluster log-space
    softmax over the cohort members only. Non-members, and members of a
    cluster whose cohort is empty, come out exactly 0; the seg-max shift
    is guarded so an empty (cluster ∩ cohort) gives 0, never NaN."""
    lab = labels.long()
    m = cohort_mask.bool()
    onehot = F.one_hot(lab, num_clusters).float() * m[:, None].float()
    logits = _device_logits(klds, sizes, beta)
    neg_inf = torch.full_like(onehot, -float("inf"))
    seg_max = torch.where(onehot > 0, logits[:, None], neg_inf).max(0).values
    seg_max_safe = torch.where(torch.isfinite(seg_max), seg_max,
                               torch.zeros_like(seg_max))
    shifted = torch.where(m, logits - seg_max_safe[lab],
                          torch.full_like(logits, -float("inf")))
    e = torch.exp(shifted)                                        # [K]
    denom = onehot.T @ e                                          # [C]
    d = denom[lab]
    return torch.where(m & (d > 0), e / torch.where(d > 0, d,
                                                    torch.ones_like(d)),
                       torch.zeros_like(e))


def activation_weights(acts: torch.Tensor, sizes: torch.Tensor,
                       labels: torch.Tensor, num_clusters: int,
                       beta: float = 150.0,
                       cohort_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end Eq. 13-15: returns (intra-cluster weights, klds). With
    ``cohort_mask`` ([K] bool) the weights renormalize over the cohort;
    the KLDs stay full-cluster (participation only gates who
    synchronizes this round)."""
    P = torch.softmax(acts.float(), dim=-1)
    klds = cluster_klds(P, labels, num_clusters)
    if cohort_mask is not None:
        w = cohort_federation_weights(klds, sizes, labels, cohort_mask,
                                      num_clusters, beta)
    else:
        w = federation_weights(klds, sizes, labels, num_clusters, beta)
    return w, klds
