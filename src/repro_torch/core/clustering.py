"""K-means clustering of discriminator mid-layer activations — paper §4.5
(port of the device path of ``repro.core.clustering``: the functions the
trainer's clustered round runs).

k-means++ seeding, a Lloyd loop with the convergence exit and the
distinct farthest-point re-seed of empty clusters, silhouette selection
of k over [2, k_selection_bound] (first maximum wins, k = 1 below
``min_silhouette``), and first-occurrence label canonicalization. The
assignment step goes through kernel K2 behind ``use_kernel``.

The reference seeds k-means++ from ``jax.random.categorical``, which
torch cannot reproduce. ``kmeans`` and ``cluster_activations``
therefore take optional initial centres (one ``[k, D]`` per candidate
k); without them the seeding draws from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    centers[0] = x[first[0]]
    for j in range(1, k):
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1).min(1).values
        # degenerate (all points on chosen centres): uniform draw
        probs = torch.where(d2.sum() > 1e-12, d2, torch.ones_like(d2))
        idx = torch.multinomial(probs, 1, generator=gen)
        centers[j] = x[idx[0]]
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
        if it > 0 and bool(torch.equal(new_labels, labels)):
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
            idx = torch.argmax(torch.where(taken, neg_inf, d2u))
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
    valid = bool((counts > 0).sum() >= 2) and n >= 3
    return (s.mean() if valid else torch.tensor(-1.0, device=x.device)
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
        return labels, k, float(sil)
    upper = k_selection_bound(K, k_max=k_max)
    cands = [run(kk) for kk in range(2, upper + 1)]
    sils = torch.stack([s for _, s in cands])
    best = int(torch.argmax(sils))               # first max wins
    sil = float(sils[best])
    if sil < min_silhouette:
        return torch.zeros(K, dtype=torch.int32, device=acts.device), 1, 0.0
    return cands[best][0].to(torch.int32), best + 2, sil
