"""The clustering of the paper's §4.5 in plain PyTorch and float64: which
cluster each client lands in, and how many clusters there are.

The clients' middle activations are standardized per feature; for every
candidate k in [2, min(k_max, max(2, K // 2))], in turn, k-means++ draws
k seeds (the first uniformly, each next one with probability
proportional to the squared distance to the nearest seed drawn, or
uniformly where every point sits on a seed) and Lloyd's algorithm runs
from them (stop once an update leaves the labels as they were; an empty
cluster takes the point farthest from the non-empty means that no empty
cluster took yet); the labels are renumbered in order of first
appearance and scored by their mean silhouette (a client alone in its
cluster scores 0). The first k with the highest score wins, and k = 1
(one cluster) where that score is under ``min_silhouette``.

The seeds are drawn from a ``torch.Generator`` with the calls a
k-means++ seeding makes (one ``randint`` for the first, one
``multinomial`` over float32 weights for each next one), so a generator
put in the state the program's clustering started from draws the same
seeds wherever the weights agree.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def standardize(acts: torch.Tensor) -> torch.Tensor:
    a = acts.double()
    return (a - a.mean(0)) / (a.std(0, correction=0) + 1e-8)


def sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[N, M] squared euclidean distances, clipped at 0."""
    d2 = ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
          + (c * c).sum(-1)[None, :])
    return d2.clamp_min(0.0)


def seeds(x: torch.Tensor, k: int, gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeds drawn from ``gen``."""
    n = x.shape[0]
    chosen = [int(torch.randint(0, n, (1,), generator=gen,
                                device=x.device)[0])]
    for _ in range(1, k):
        d2 = sq_dists(x, x[chosen]).min(1).values
        w = d2 if float(d2.sum()) > 1e-12 else torch.ones_like(d2)
        chosen.append(int(torch.multinomial(w.float(), 1, generator=gen)[0]))
    return x[chosen].clone()


def lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int = 50
          ) -> torch.Tensor:
    """Labels [N] of Lloyd's algorithm from ``centers``."""
    n, k = x.shape[0], centers.shape[0]
    labels = None
    for _ in range(iters):
        new_labels = sq_dists(x, centers).argmin(1)
        if labels is not None and torch.equal(new_labels, labels):
            break
        counts = torch.bincount(new_labels, minlength=k)
        sums = torch.zeros_like(centers).index_add_(0, new_labels, x)
        full = counts > 0
        new = torch.where(full[:, None],
                          sums / counts.clamp_min(1)[:, None].double(),
                          centers)
        far = sq_dists(x, new[full]).min(1).values
        taken = torch.zeros(n, dtype=torch.bool, device=x.device)
        for c in range(k):
            if counts[c] == 0:
                idx = int(torch.where(taken, -torch.inf, far).argmax())
                new[c] = x[idx]
                taken[idx] = True
        centers, labels = new, new_labels
    return sq_dists(x, centers).argmin(1)


def first_appearance(labels: torch.Tensor) -> torch.Tensor:
    order: List[int] = []
    for v in labels.tolist():
        if v not in order:
            order.append(v)
    table = {v: i for i, v in enumerate(order)}
    return torch.tensor([table[v] for v in labels.tolist()],
                        dtype=torch.int64, device=labels.device)


def silhouette(x: torch.Tensor, labels: torch.Tensor) -> float:
    """Mean silhouette (a client alone in its cluster scores 0); -1 with
    fewer than two clusters or three clients."""
    n = x.shape[0]
    _, lab = torch.unique(labels, return_inverse=True)
    onehot = torch.nn.functional.one_hot(lab).double()          # [N, C]
    if onehot.shape[1] < 2 or n < 3:
        return -1.0
    d = sq_dists(x, x).sqrt()
    counts = onehot.sum(0)
    sums = d @ onehot
    rows = torch.arange(n, device=x.device)
    own = counts[lab]
    a = sums[rows, lab] / (own - 1).clamp_min(1)
    mean = sums / counts
    mean[rows, lab] = torch.inf
    b = mean.min(1).values
    top = torch.maximum(a, b)
    s = torch.where((own <= 1) | (top <= 0), torch.zeros_like(a),
                    (b - a) / top)
    return float(s.mean())


def cluster(acts: torch.Tensor, gen: torch.Generator, k_max: int = 6,
            min_silhouette: float = 0.15, iters: int = 50
            ) -> Tuple[torch.Tensor, int, float, List[float]]:
    """(labels [K], k, silhouette, every candidate's silhouette) of the
    clients' activations ``acts`` [K, F], seeds drawn from ``gen``."""
    x = standardize(acts)
    K = x.shape[0]
    upper = min(k_max, max(2, K // 2))
    cands = []
    for k in range(2, upper + 1):
        lab = first_appearance(lloyd(x, seeds(x, k, gen), iters))
        cands.append((lab, silhouette(x, lab)))
    sils = [s for _, s in cands]
    best = max(range(len(sils)), key=lambda i: (sils[i], -i))
    if sils[best] < min_silhouette:
        return (torch.zeros(K, dtype=torch.int64, device=acts.device), 1,
                0.0, sils)
    return cands[best][0], best + 2, sils[best], sils


def cost(acts: torch.Tensor, labels: torch.Tensor) -> float:
    """Within-cluster sum of squared distances to the cluster's mean, on
    the standardized activations."""
    x = standardize(acts)
    lab = labels.long().to(x.device)
    return float(sum(((x[lab == c] - x[lab == c].mean(0)) ** 2).sum()
                     for c in torch.unique(lab)))


def pair_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of client pairs that one labelling puts together and the
    other apart (0 for the same partition, under any numbering)."""
    a, b = a.long().cpu(), b.long().cpu()
    n = a.numel()
    if n < 2:
        return 0.0
    same_a = a[:, None] == a[None, :]
    same_b = b[:, None] == b[None, :]
    diff = (same_a != same_b).triu(1).sum()
    return float(diff) / (n * (n - 1) / 2)
