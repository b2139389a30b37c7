"""Non-IID client partitioner reproducing the paper's scenarios (port
of ``repro.data.partition``; numpy only).

The paper's heterogeneity recipe (§6.1.x):
  * label exclusion — "40 clients have 2 labels excluded, 10 have 3, ..."
  * dataset-size variation — clients hold 600 / 400 / 200 / 100 samples
  * multi-domain — disjoint client groups draw from different domains

`ClientSpec` captures one client's data; `build_scenario` constructs the
paper's eight scenarios (parameterized so tests can shrink them).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import DOMAINS, NUM_CLASSES, make_dataset


@dataclasses.dataclass
class ClientSpec:
    client_id: int
    domain: str
    images: np.ndarray  # [n, H, W, 1]
    labels: np.ndarray  # [n]

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    def label_distribution(self) -> np.ndarray:
        hist = np.bincount(self.labels, minlength=NUM_CLASSES).astype(np.float64)
        return hist / max(hist.sum(), 1.0)


def _exclude_labels(images, labels, excluded: Sequence[int]):
    mask = ~np.isin(labels, np.asarray(list(excluded), dtype=labels.dtype))
    return images[mask], labels[mask]


def partition_domain(domain: str, client_ids: Sequence[int], *,
                     sizes: Sequence[int], exclusions: Sequence[Sequence[int]],
                     img_size: int = 28, seed: int = 0) -> List[ClientSpec]:
    """Build one domain's client population.

    sizes[i] / exclusions[i] describe client i (pre-exclusion target size).
    """
    assert len(client_ids) == len(sizes) == len(exclusions)
    out = []
    for i, cid in enumerate(client_ids):
        # oversample so exclusion still leaves ~sizes[i] items
        raw_n = int(sizes[i] * (1.0 + 0.25 * len(exclusions[i]) + 0.2)) + 8
        imgs, labs = make_dataset(domain, raw_n, img_size=img_size,
                                  seed=seed * 10007 + cid)
        if exclusions[i]:
            imgs, labs = _exclude_labels(imgs, labs, exclusions[i])
        imgs, labs = imgs[: sizes[i]], labs[: sizes[i]]
        out.append(ClientSpec(cid, domain, imgs, labs))
    return out


def paper_exclusion_plan(num_clients: int, plan: Sequence[Tuple[int, int]],
                         seed: int = 0) -> List[List[int]]:
    """plan: [(num_clients_affected, num_labels_excluded), ...].

    Remaining clients keep all labels. Mirrors e.g. 'within each domain,
    20 clients have two labels excluded, 5 have three, 5 have four'.
    """
    rng = np.random.default_rng(seed)
    exclusions: List[List[int]] = [[] for _ in range(num_clients)]
    order = rng.permutation(num_clients)
    idx = 0
    for count, n_excl in plan:
        for _ in range(count):
            if idx >= num_clients:
                break
            cid = order[idx]
            exclusions[cid] = list(rng.choice(NUM_CLASSES, n_excl, replace=False))
            idx += 1
    return exclusions


def build_scenario(name: str, *, num_clients: int = 100, base_size: int = 600,
                   img_size: int = 28, seed: int = 0) -> List[ClientSpec]:
    """The paper's test scenarios (Table 5), shrinkable for tests.

    Supported names:
      1dom_iid | 1dom_noniid | 2dom_iid | 2dom_noniid | 2dom_highly_noniid
      | 4dom_iid | 2dom_medical | 2dom_highres  (last two map to distinct
      synthetic domain pairs since the real datasets are offline-absent)
    """
    rng = np.random.default_rng(seed + 99)
    half = num_clients // 2
    quarter = num_clients // 4

    def scale(x):  # scale the paper's per-100-client counts
        return max(1, int(round(x * num_clients / 100)))

    if name == "1dom_iid":
        sizes = [base_size] * num_clients
        excl = [[] for _ in range(num_clients)]
        return partition_domain("gratings", range(num_clients), sizes=sizes,
                                exclusions=excl, img_size=img_size, seed=seed)

    if name == "1dom_noniid":
        plan = [(scale(40), 2), (scale(10), 3), (scale(10), 4)]
        excl = paper_exclusion_plan(num_clients, plan, seed)
        sizes = [base_size if rng.random() < 0.5 else int(base_size * 2 / 3)
                 for _ in range(num_clients)]
        return partition_domain("gratings", range(num_clients), sizes=sizes,
                                exclusions=excl, img_size=img_size, seed=seed)

    def two_dom(d0, d1, noniid: bool, highly: bool = False):
        specs: List[ClientSpec] = []
        for g, dom in ((0, d0), (1, d1)):
            ids = list(range(g * half, g * half + half))
            if highly:
                plan = [(scale(20) // 1, 2), (scale(30), 3)]
                size_pool = [base_size, base_size // 3, base_size // 6]
            elif noniid:
                plan = [(scale(20), 2), (scale(5), 3), (scale(5), 4)]
                size_pool = [base_size, int(base_size * 2 / 3)]
            else:
                plan, size_pool = [], [base_size]
            excl = paper_exclusion_plan(half, plan, seed + g)
            sizes = [int(rng.choice(size_pool)) for _ in range(half)]
            specs += partition_domain(dom, ids, sizes=sizes, exclusions=excl,
                                      img_size=img_size, seed=seed + g)
        return specs

    if name == "2dom_iid":
        return two_dom("gratings", "blobs", noniid=False)
    if name == "2dom_noniid":
        return two_dom("gratings", "blobs", noniid=True)
    if name == "2dom_highly_noniid":
        return two_dom("gratings", "blobs", noniid=True, highly=True)
    if name == "2dom_medical":
        return two_dom("rings", "checkers", noniid=True)
    if name == "2dom_highres":
        return two_dom("checkers", "blobs", noniid=True, highly=True)

    if name == "4dom_iid":
        specs = []
        for g, dom in enumerate(DOMAINS):
            ids = list(range(g * quarter, (g + 1) * quarter))
            sizes = [base_size] * quarter
            excl = [[] for _ in range(quarter)]
            specs += partition_domain(dom, ids, sizes=sizes, exclusions=excl,
                                      img_size=img_size, seed=seed + g)
        return specs

    raise ValueError(f"unknown scenario {name}")


def padded_stack(specs: Sequence[ClientSpec]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack clients' datasets into padded per-client rows.

    Returns (images [K, n_max, H, W, C] f32 zero-padded,
    labels [K, n_max] int32 with ``-1`` sentinel padding,
    counts [K] int32). The sentinel makes an out-of-range gather
    observable — samplers must only draw indices below ``counts``
    (see repro_torch.data.pipeline).
    """
    k = len(specs)
    n_max = max(s.n for s in specs)
    images = np.zeros((k, n_max) + specs[0].images.shape[1:], np.float32)
    labels = np.full((k, n_max), -1, np.int32)
    counts = np.zeros(k, np.int32)
    for i, s in enumerate(specs):
        images[i, : s.n] = s.images
        labels[i, : s.n] = s.labels
        counts[i] = s.n
    return images, labels, counts


def batches(spec: ClientSpec, batch_size: int, rng: np.random.Generator):
    """Yield an epoch of shuffled batches (pads by wraparound)."""
    n = spec.n
    idx = rng.permutation(n)
    n_batches = max(1, n // batch_size)
    for b in range(n_batches):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        if sel.shape[0] < batch_size:
            sel = np.concatenate([sel, idx[: batch_size - sel.shape[0]]])
        yield spec.images[sel], spec.labels[sel]
