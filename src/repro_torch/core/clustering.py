"""K-means clustering of discriminator mid-layer activations — paper §4.5
(port of the device path of ``repro.core.clustering``: the functions the
trainer's clustered round runs).

k-means++ seeding, a Lloyd loop with the convergence exit and the
distinct farthest-point re-seed of empty clusters, silhouette selection
of k over [2, k_selection_bound] (first maximum wins, k = 1 below
``min_silhouette``), and first-occurrence label canonicalization. The
assignment step goes through kernel K2 behind ``use_kernel``. Every
device value the device path reads on the host goes through
``trace.readback``, which counts it by site.

The reference seeds k-means++ from ``jax.random.categorical``, which
torch cannot reproduce. ``kmeans`` and ``cluster_activations``
therefore take optional initial centres (one ``[k, D]`` per candidate
k); without them the seeding draws from a ``torch.Generator``.

The reference's host numpy path (the trainer's ``fused_cluster=False``
and label-KLD rounds) is copied line for line below, with an ``_np``
suffix where a name collides with the device path:
``kmeans_pp_init_np``, ``kmeans_np``, ``silhouette_np``,
``canonicalize_labels_np``, ``ClusterResult``, ``cluster_activations_np``.
Seeded from numpy, it gives the reference's labels, k and silhouette
exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import ops as kops


def k_selection_bound(n_clients: int, k: Optional[int] = None,
                      k_max: int = 6) -> int:
    """Static upper bound on cluster ids out of ``cluster_activations``:
    the silhouette-selection candidate cap (or the forced k)."""
    if k is not None:
        return max(1, int(k))
    return min(k_max, max(2, n_clients // 2))


def canonicalize_labels(labels: torch.Tensor, num_clusters: int
                        ) -> torch.Tensor:
    """Relabel to first-occurrence order; ``num_clusters`` bounds the
    ids."""
    n = labels.shape[0]
    first = torch.full((num_clusters,), n, dtype=torch.int64,
                       device=labels.device)
    first = first.scatter_reduce(0, labels.long(),
                                 torch.arange(n, device=labels.device),
                                 reduce="amin")
    # appearance rank; absent clusters (first == n) sort last, stably
    rank = torch.argsort(torch.argsort(first, stable=True), stable=True)
    return rank[labels.long()].to(labels.dtype)


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[N, M] squared euclidean distances, clipped at 0."""
    d2 = ((x * x).sum(-1)[:, None] - 2.0 * x @ centers.T
          + (centers * centers).sum(-1)[None, :])
    return torch.clamp_min(d2, 0.0)


def _assign(x: torch.Tensor, centers: torch.Tensor,
            use_kernel: bool) -> torch.Tensor:
    """argmin_m ||x - c_m||^2 — kernel K2 behind use_kernel (the
    ||x||^2 term is constant under argmin either way)."""
    if use_kernel:
        return kops.kmeans_assign(x, centers.contiguous())
    scores = -2.0 * x @ centers.T + (centers * centers).sum(-1)[None, :]
    return torch.argmin(scores, dim=1).to(torch.int32)


def kmeans_pp_init(x: torch.Tensor, k: int, gen: torch.Generator
                   ) -> torch.Tensor:
    """k-means++ seeding drawn from ``gen`` (on x's device). Unfilled
    centre slots sit at +inf so distance minima only see chosen ones."""
    n = x.shape[0]
    centers = torch.full((k,) + x.shape[1:], float("inf"), dtype=x.dtype,
                         device=x.device)
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centers[0] = x[int(trace.readback("kmeans_pp.seed", first[0]))]
    for j in range(1, k):
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1).min(1).values
        # degenerate (all points on chosen centres): uniform draw
        probs = torch.where(d2.sum() > 1e-12, d2, torch.ones_like(d2))
        idx = torch.multinomial(probs, 1, generator=gen)
        centers[j] = x[int(trace.readback("kmeans_pp.seed", idx[0]))]
    return centers


def kmeans(x: torch.Tensor, k: int, *, init_centers: torch.Tensor = None,
           gen: Optional[torch.Generator] = None, iters: int = 50,
           use_kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd loop: returns (labels [N] int32, centers [k, D]). Starts
    from ``init_centers`` when given, else from k-means++ on ``gen``.
    Stops when the labels are stable after the first update; a
    converged step keeps the previous centres. Empty clusters re-seed
    at distinct farthest points from the updated non-empty centres."""
    n = x.shape[0]
    if k <= 1:
        return (torch.zeros(n, dtype=torch.int32, device=x.device),
                x.mean(0, keepdim=True))
    centers = (kmeans_pp_init(x, k, gen) if init_centers is None
               else init_centers.to(device=x.device, dtype=x.dtype).clone())
    labels = torch.zeros(n, dtype=torch.int32, device=x.device)
    for it in range(iters):
        new_labels = _assign(x, centers, use_kernel)
        if it > 0 and bool(trace.readback("kmeans.converged",
                                          (new_labels == labels).all())):
            break
        onehot = F.one_hot(new_labels.long(), k).to(x.dtype)      # [N, k]
        counts = onehot.sum(0)
        sums = onehot.T @ x
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts, 1.0)[:, None],
                          centers)
        d2c = _sq_dists(x, new)
        d2u = torch.where(counts[None, :] > 0, d2c,
                          torch.full_like(d2c, float("inf"))).min(1).values
        taken = torch.zeros(n, dtype=torch.bool, device=x.device)
        neg_inf = torch.full_like(d2u, -float("inf"))
        for c in range(k):                       # k small: unrolled
            empty = counts[c] == 0
            idx = int(trace.readback(
                "kmeans.reseed", torch.argmax(torch.where(taken, neg_inf,
                                                          d2u))))
            new[c] = torch.where(empty, x[idx], new[c])
            taken[idx] = taken[idx] | empty
        centers, labels = new, new_labels
    return _assign(x, centers, use_kernel), centers


def silhouette(x: torch.Tensor, labels: torch.Tensor,
               num_clusters: int) -> torch.Tensor:
    """Mean silhouette coefficient (singleton clusters score 0); -1.0
    when fewer than two clusters appear or n < 3. f32 scalar."""
    n = x.shape[0]
    d = torch.sqrt(_sq_dists(x, x))
    onehot = F.one_hot(labels.long(), num_clusters).to(x.dtype)  # [N, C]
    counts = onehot.sum(0)
    sums = d @ onehot                                             # [N, C]
    own = counts[labels.long()]
    a = sums[torch.arange(n, device=x.device), labels.long()] \
        / torch.clamp_min(own - 1.0, 1.0)
    inf = torch.full_like(sums, float("inf"))
    mean_c = torch.where(counts[None, :] > 0,
                         sums / torch.clamp_min(counts, 1.0)[None, :], inf)
    mean_c = torch.where(onehot > 0, inf, mean_c)
    b = mean_c.min(1).values
    denom = torch.maximum(a, b)
    s = torch.where((own <= 1) | (denom <= 0), torch.zeros_like(a),
                    (b - a) / denom)
    valid = bool(trace.readback("silhouette.valid",
                                (counts > 0).sum() >= 2)) and n >= 3
    return (s.mean() if valid else torch.full((), -1.0, device=x.device)
            ).to(torch.float32)


def cluster_activations(acts: torch.Tensor, *, k: Optional[int] = None,
                        k_max: int = 6, min_silhouette: float = 0.15,
                        iters: int = 50, use_kernel: bool = False,
                        gen: Optional[torch.Generator] = None,
                        init_centers: Optional[Dict[int, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, int, float]:
    """Cluster client activation vectors [K_clients, D]: returns (labels
    [K] int32 on acts' device, selected k, silhouette). With ``k`` given
    it is used; otherwise k is chosen by silhouette over [2, bound],
    falling back to k = 1 below ``min_silhouette``. ``init_centers``
    maps a candidate k to its initial ``[k, D]`` centres."""
    K = acts.shape[0]
    z = ((acts - acts.mean(0)) / (acts.std(0, correction=0) + 1e-8)).float()

    def run(kk):
        c0 = None if init_centers is None else init_centers[kk]
        labels, _ = kmeans(z, kk, init_centers=c0, gen=gen, iters=iters,
                           use_kernel=use_kernel)
        labels = canonicalize_labels(labels, kk)
        return labels, silhouette(z, labels, kk)

    if k is not None:
        if k <= 1:
            return torch.zeros(K, dtype=torch.int32, device=acts.device), 1, 0.0
        labels, sil = run(k)
        return labels, k, float(trace.readback("cluster.select", sil))
    upper = k_selection_bound(K, k_max=k_max)
    cands = [run(kk) for kk in range(2, upper + 1)]
    sils = torch.stack([s for _, s in cands])
    best = torch.argmax(sils).reshape(1)         # first max wins
    best, sil = trace.readback("cluster.select", torch.cat(
        [best.to(sils.dtype), sils.index_select(0, best)])).tolist()
    best = int(best)
    if sil < min_silhouette:
        return torch.zeros(K, dtype=torch.int32, device=acts.device), 1, 0.0
    return cands[best][0].to(torch.int32), best + 2, sil


# ---------------------------------------------------------------------------
# host path (numpy), the reference's oracle
# ---------------------------------------------------------------------------

def kmeans_pp_init_np(x: np.ndarray, k: int, rng: np.random.Generator
                      ) -> np.ndarray:
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(((x[:, None, :] - np.array(centers)[None]) ** 2).sum(-1), 1)
        total = d2.sum()
        if total <= 1e-12:
            centers.append(x[rng.integers(n)])
            continue
        probs = d2 / total
        centers.append(x[rng.choice(n, p=probs)])
    return np.array(centers)


def kmeans_np(x: np.ndarray, k: int, *, iters: int = 50, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Returns (labels [N], centers [k, D], inertia)."""
    rng = np.random.default_rng(seed)
    if k <= 1:
        center = x.mean(0, keepdims=True)
        inertia = float(((x - center) ** 2).sum())
        return np.zeros(x.shape[0], np.int32), center, inertia
    centers = kmeans_pp_init_np(x, k, rng)
    labels = np.zeros(x.shape[0], np.int32)
    for it in range(iters):
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        new_labels = d2.argmin(1).astype(np.int32)
        if np.array_equal(new_labels, labels) and it > 0:
            break
        labels = new_labels
        empties = []
        for c in range(k):
            mask = labels == c
            if mask.any():
                centers[c] = x[mask].mean(0)
            else:
                empties.append(c)
        if empties:
            # re-seed empty clusters at distinct farthest points from the
            # updated non-empty centres
            valid = [c for c in range(k) if c not in empties]
            d2u = ((x[:, None, :] - centers[valid][None]) ** 2
                   ).sum(-1).min(1)
            for c in empties:
                i = int(d2u.argmax())
                centers[c] = x[i]
                d2u[i] = -np.inf
    inertia = float(((x - centers[labels]) ** 2).sum())
    return labels, centers, inertia


def silhouette_np(x: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient (euclidean); singleton clusters score
    0, and -1.0 when fewer than two clusters appear or n < 3."""
    n = x.shape[0]
    uniq = np.unique(labels)
    if uniq.size < 2 or n < 3:
        return -1.0
    d = np.sqrt(np.maximum(((x[:, None, :] - x[None]) ** 2).sum(-1), 0.0))
    s = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        if not same.any():          # singleton cluster
            continue
        a = d[i][same].mean()
        bs = [d[i][labels == c].mean() for c in uniq if c != labels[i]]
        b = min(bs)
        s[i] = 0.0 if max(a, b) == 0 else (b - a) / max(a, b)
    return float(s.mean())


def canonicalize_labels_np(labels: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Relabel clusters to first-occurrence order. Returns (canonical
    labels, old->new id map over [0, labels.max()])."""
    labels = np.asarray(labels)
    uniq, first = np.unique(labels, return_index=True)
    order = np.argsort(first)            # uniq[order] = appearance order
    remap = np.zeros(int(uniq.max()) + 1, labels.dtype)
    remap[uniq[order]] = np.arange(order.size, dtype=labels.dtype)
    return remap[labels], remap


@dataclasses.dataclass
class ClusterResult:
    labels: np.ndarray
    centers: np.ndarray
    k: int
    silhouette: float


def cluster_activations_np(acts: np.ndarray, *, k: Optional[int] = None,
                           k_max: int = 6, seed: int = 0,
                           min_silhouette: float = 0.15) -> ClusterResult:
    """Cluster client activation vectors [K_clients, D] on the host: with
    ``k`` given it is used; otherwise k is chosen by silhouette over
    [2, bound], accepting k = 1 below ``min_silhouette``."""
    mu, sd = acts.mean(0), acts.std(0) + 1e-8
    z = (acts - mu) / sd

    def _canonical(labels, centers):
        new_labels, remap = canonicalize_labels_np(labels)
        # centre rows of appearing clusters move to their new ids; rows
        # of empty clusters land past them and are never referenced
        new = centers.copy()
        for old in np.unique(labels):
            new[remap[old]] = centers[old]
        return new_labels, new

    if k is not None:
        labels, centers, _ = kmeans_np(z, k, seed=seed)
        labels, centers = _canonical(labels, centers)
        return ClusterResult(labels, centers, k, silhouette_np(z, labels))
    best: Optional[ClusterResult] = None
    upper = k_selection_bound(acts.shape[0], k_max=k_max)
    for kk in range(2, upper + 1):
        labels, centers, _ = kmeans_np(z, kk, seed=seed)
        labels, centers = _canonical(labels, centers)
        sil = silhouette_np(z, labels)
        if best is None or sil > best.silhouette:
            best = ClusterResult(labels, centers, kk, sil)
    if best is None or best.silhouette < min_silhouette:
        labels, centers, _ = kmeans_np(z, 1, seed=seed)
        return ClusterResult(labels, centers, 1, 0.0)
    return best
