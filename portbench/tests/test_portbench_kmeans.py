"""The reference's k-means (``portbench.reference.kmeans``) against the
port's clustering at a tiny size on the CPU: from a generator in the
same state both put every client in the same cluster and choose the
same k, and the comparison's numbers catch a clustering that puts every
client in one cluster and a kernel K2 that assigns one client wrong.
(The tiny cell's own rounds choose one cluster, their silhouettes under
the threshold, so these faults are read there at the cells' sizes.)"""
import json

import pytest
import torch

from portbench import program, registry
from portbench.reference import kmeans

LIMITS = json.loads((registry.ROOT / "portbench/limits/gan100-train.json")
                    .read_text())["limits"]


def _acts(seed, n=24, f=48):
    """Clients' activations in three groups a few spreads apart, a mean
    and a scale per feature."""
    g = torch.Generator().manual_seed(seed)
    centers = 3.0 * torch.randn(3, f, generator=g)
    which = torch.randint(0, 3, (n,), generator=g)
    x = centers[which] + torch.randn(n, f, generator=g)
    return (x * torch.rand(f, generator=g) + torch.randn(f, generator=g)
            ).float()


def _program(acts, gen_seed):
    from repro_torch.core import huscf
    gen = torch.Generator().manual_seed(gen_seed)
    labels, k, sil = huscf.cluster_activations(acts, use_kernel=True,
                                               gen=gen)
    return labels.long(), k, sil


def _reference(acts, gen_seed):
    gen = torch.Generator().manual_seed(gen_seed)
    return kmeans.cluster(acts, gen)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reference_kmeans_matches_the_program(seed):
    acts = _acts(seed)
    labels, k, sil = _program(acts, 100 + seed)
    ref_labels, ref_k, ref_sil, _ = _reference(acts, 100 + seed)
    assert k == ref_k >= 2
    assert torch.equal(labels, ref_labels)
    assert abs(sil - ref_sil) < 1e-3      # float32 distances on one side
    assert kmeans.pair_gap(labels, ref_labels) == 0.0


def _numbers(labels, k, ref_labels, ref_k, acts):
    cost = kmeans.cost(acts, ref_labels)
    return {"round_k_gap": abs(k - ref_k),
            "round_pair_gap": kmeans.pair_gap(labels, ref_labels),
            "round_cost_gap": abs(kmeans.cost(acts, labels) - cost) / cost}


@pytest.mark.parametrize("fault", ["one_cluster", "k2_wrong"])
def test_a_broken_clustering_is_caught(monkeypatch, fault):
    program.plant(fault, monkeypatch.setattr)
    caught = 0
    for seed in range(4):
        acts = _acts(seed)
        labels, k, _ = _program(acts, 100 + seed)
        ref_labels, ref_k, _, _ = _reference(acts, 100 + seed)
        n = _numbers(labels, k, ref_labels, ref_k, acts)
        caught += any(n[name] > LIMITS[name] for name in n)
    assert caught == 4
