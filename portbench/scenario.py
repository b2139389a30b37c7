"""The benchmark's own copy of the paper's client scenarios (Table 5),
frozen: the client datasets every cell trains on, made from ``--seed``.

It follows the port's ``data.partition.build_scenario`` for
``2dom_noniid`` draw for draw in which clients are in which domain and
which labels they miss; a client's labels come from its own numpy
generator, as the port's do. Two things differ. The sizes are a fixed
half-and-half split in a seeded order, so that every seed trains epochs
of the same length. The images, the same procedural families (oriented
gratings; constellations of gaussian blobs) with the same pixel noise,
are drawn on the device in one batch per domain from a
``torch.Generator`` seeded from ``--seed``: the port's host loops take
8 s for 100 clients.
"""
from __future__ import annotations

import math
import zlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

NUM_CLASSES = 10


def _grid(img: int, device):
    ax = torch.linspace(-1.0, 1.0, img, device=device)
    return torch.meshgrid(ax, ax, indexing="ij")


def _gratings(cls, img, gen):
    """Class -> orientation and frequency."""
    yy, xx = _grid(img, cls.device)
    n = cls.shape[0]
    c = cls.double()

    def normal(std):
        return torch.randn(n, generator=gen, device=cls.device,
                           dtype=torch.float64) * std
    theta = c * (math.pi / NUM_CLASSES) + normal(0.05)
    freq = 4.0 + (cls % 3).double() + normal(0.1)
    phase = torch.rand(n, generator=gen, device=cls.device,
                       dtype=torch.float64) * 2 * math.pi
    t = theta[:, None, None]
    proj = torch.cos(t) * xx[None] + torch.sin(t) * yy[None]
    return torch.sin(freq[:, None, None] * math.pi * proj
                     + phase[:, None, None]).float()


def _blobs(cls, img, gen):
    """Class -> number of blobs (cls % 5 + 1) and ring radius."""
    yy, xx = _grid(img, cls.device)
    n = cls.shape[0]
    k = (cls % 5 + 1).double()[:, None]
    r = (0.25 + 0.5 * (torch.div(cls, 5, rounding_mode="floor") + 1)
         .double() / 3.0)[:, None]
    ang0 = torch.rand(n, 1, generator=gen, device=cls.device,
                      dtype=torch.float64) * 2 * math.pi
    j = torch.arange(5, device=cls.device, dtype=torch.float64)[None, :]
    a = ang0 + 2 * math.pi * j / k
    jit = torch.randn(2, n, 5, generator=gen, device=cls.device,
                      dtype=torch.float64) * 0.03
    cx = (r * torch.cos(a) + jit[0]).float()
    cy = (r * torch.sin(a) + jit[1]).float()
    img_ = torch.full((n, img, img), -1.0, device=cls.device)
    for b in range(5):
        d2 = ((xx[None] - cx[:, b, None, None]) ** 2
              + (yy[None] - cy[:, b, None, None]) ** 2)
        img_ += 2.0 * torch.exp(-d2 / 0.02) * (b < k[:, 0]).float()[:, None,
                                                                    None]
    return img_.clamp(-1.0, 1.0)


_FAMILIES = {"gratings": _gratings, "blobs": _blobs}


def client_labels(domain: str, n: int, excluded: Sequence[int], size: int,
                  seed: int) -> np.ndarray:
    """A client's labels, as the port draws them (its raw draws, the
    excluded labels removed, cut to ``size``)."""
    rng = np.random.default_rng(seed + zlib.crc32(domain.encode()) % 2 ** 16)
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    if excluded:
        labels = labels[~np.isin(labels, np.asarray(excluded, np.int32))]
    return labels[:size]


def images(domain: str, labels: np.ndarray, img: int,
           gen: torch.Generator, noise: float = 0.12) -> torch.Tensor:
    """``[n, img, img, 1]`` images of ``domain`` for ``labels``, on the
    generator's device, in [-1, 1]."""
    cls = torch.as_tensor(labels, device=gen.device).long()
    x = _FAMILIES[domain](cls, img, gen)
    x = x + torch.randn(x.shape, generator=gen, device=gen.device) * noise
    return x.clamp(-1.0, 1.0)[..., None]


def exclusion_plan(num_clients: int, plan, seed: int) -> List[List[int]]:
    rng = np.random.default_rng(seed)
    excl: List[List[int]] = [[] for _ in range(num_clients)]
    order = rng.permutation(num_clients)
    idx = 0
    for count, n_excl in plan:
        for _ in range(count):
            if idx >= num_clients:
                break
            excl[order[idx]] = list(rng.choice(NUM_CLASSES, n_excl,
                                               replace=False))
            idx += 1
    return excl


def two_domain_noniid(num_clients: int, base_size: int, img: int,
                      seed: int, device="cpu"
                      ) -> List[Tuple[str, np.ndarray, np.ndarray]]:
    """``2dom_noniid``: half the clients on gratings, half on blobs; per
    100 clients, 20 of each domain miss 2 labels, 5 miss 3 and 5 miss 4;
    half of each domain's clients hold ``base_size`` images and half two
    thirds of it, in an order drawn from the seed (the port draws each
    size on its own; a fixed split gives every seed the same epoch). Returns each
    client's (domain, images [n, img, img, 1] in [-1, 1], labels [n])."""
    rng = np.random.default_rng(seed + 99)
    half = num_clients // 2

    def scale(x):
        return max(1, int(round(x * num_clients / 100)))

    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + 17) % 2 ** 63)
    out = []
    for g, dom in enumerate(("gratings", "blobs")):
        plan = [(scale(20), 2), (scale(5), 3), (scale(5), 4)]
        excl = exclusion_plan(half, plan, seed + g)
        small = int(base_size * 2 / 3)
        sizes = [int(x) for x in rng.permutation(
            [base_size] * (half - half // 2) + [small] * (half // 2))]
        labs = [client_labels(dom, int(sizes[i] * (1.0 + 0.25 * len(excl[i])
                                                   + 0.2)) + 8,
                              excl[i], sizes[i], (seed + g) * 10007
                              + g * half + i)
                for i in range(half)]
        imgs = images(dom, np.concatenate(labs), img, gen).cpu().numpy()
        for lab, x in zip(labs, np.split(imgs, np.cumsum(
                [len(x) for x in labs])[:-1])):
            out.append((dom, x, lab))
    return out


SCENARIOS = {"2dom_noniid": two_domain_noniid}


def build(name: str, num_clients: int, base_size: int, img: int,
          seed: int, device="cpu"
          ) -> Sequence[Tuple[str, np.ndarray, np.ndarray]]:
    return SCENARIOS[name](num_clients, base_size, img, seed, device)
