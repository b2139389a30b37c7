"""Procedural multi-domain image datasets (port of
``repro.data.synthetic``; numpy only, same bytes for the same seed).

The paper evaluates on MNIST / FMNIST / KMNIST / NotMNIST / MedMNIST /
CIFAR10 / SVHN — none of which are available offline.  We generate
*structured* class-conditional image families whose statistics mimic the
relevant properties:

 * each **domain** is a distinct procedural family (oriented gratings,
   gaussian blob constellations, checkerboards, concentric rings) so the
   discriminator's mid-layer activations genuinely separate domains —
   which is exactly what HuSCF-GAN's clustering stage must detect;
 * each **class** (10 per domain) parameterizes the family (orientation,
   blob layout, frequency, radius) so class-conditional generation and
   classifier-based evaluation are meaningful;
 * pixel noise + per-sample jitter make the task non-trivial.

Images are [H, W, 1] float32 in [-1, 1] (cGAN tanh range), default 28x28.
"""
from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np

DOMAINS = ("gratings", "blobs", "checkers", "rings")
NUM_CLASSES = 10


def _grid(img_size: int):
    ax = np.linspace(-1.0, 1.0, img_size, dtype=np.float32)
    return np.meshgrid(ax, ax, indexing="ij")


def _gratings(cls: np.ndarray, img_size: int, rng: np.random.Generator):
    """Oriented sinusoidal gratings; class -> orientation."""
    yy, xx = _grid(img_size)
    n = cls.shape[0]
    theta = cls * (np.pi / NUM_CLASSES) + rng.normal(0, 0.05, n)
    freq = 4.0 + (cls % 3) + rng.normal(0, 0.1, n)
    phase = rng.uniform(0, 2 * np.pi, n)
    t = theta[:, None, None]
    proj = np.cos(t) * xx[None] + np.sin(t) * yy[None]
    return np.sin(freq[:, None, None] * np.pi * proj + phase[:, None, None])


def _blobs(cls: np.ndarray, img_size: int, rng: np.random.Generator):
    """Constellations of gaussian blobs; class -> #blobs and ring radius."""
    yy, xx = _grid(img_size)
    n = cls.shape[0]
    img = np.full((n, img_size, img_size), -1.0, np.float32)
    for i in range(n):
        k = int(cls[i]) % 5 + 1
        r = 0.25 + 0.5 * ((int(cls[i]) // 5) + 1) / 3.0
        ang0 = rng.uniform(0, 2 * np.pi)
        for j in range(k):
            a = ang0 + 2 * np.pi * j / k
            cx, cy = r * np.cos(a), r * np.sin(a)
            cx += rng.normal(0, 0.03)
            cy += rng.normal(0, 0.03)
            d2 = (xx - cx) ** 2 + (yy - cy) ** 2
            img[i] += 2.0 * np.exp(-d2 / 0.02)
    return np.clip(img, -1.0, 1.0)


def _checkers(cls: np.ndarray, img_size: int, rng: np.random.Generator):
    """Checkerboards; class -> tile count, parity."""
    yy, xx = _grid(img_size)
    n = cls.shape[0]
    tiles = 2.0 + (cls % 5)
    parity = (cls // 5).astype(np.float32)
    ox = rng.uniform(-0.1, 0.1, n)[:, None, None]
    oy = rng.uniform(-0.1, 0.1, n)[:, None, None]
    t = tiles[:, None, None]
    a = np.floor((xx[None] + 1 + ox) * t / 2) + np.floor((yy[None] + 1 + oy) * t / 2)
    board = (np.mod(a, 2.0) * 2.0 - 1.0)
    return board * (1.0 - 2.0 * parity[:, None, None])


def _rings(cls: np.ndarray, img_size: int, rng: np.random.Generator):
    """Concentric rings; class -> radial frequency & center offset."""
    yy, xx = _grid(img_size)
    n = cls.shape[0]
    freq = 2.0 + (cls % 5) * 1.5
    off = 0.3 * (cls // 5).astype(np.float32)
    jx = rng.normal(0, 0.02, n)[:, None, None]
    jy = rng.normal(0, 0.02, n)[:, None, None]
    rr = np.sqrt((xx[None] - off[:, None, None] - jx) ** 2 + (yy[None] - jy) ** 2)
    return np.cos(freq[:, None, None] * np.pi * rr)


_FAMILIES = {"gratings": _gratings, "blobs": _blobs,
             "checkers": _checkers, "rings": _rings}


def _domain_salt(domain: str) -> int:
    # NOT hash(): str hashing is randomized per process (PYTHONHASHSEED),
    # which made seed= silently non-reproducible across runs.
    return zlib.crc32(domain.encode()) % (2 ** 16)


def make_dataset(domain: str, n: int, *, img_size: int = 28, seed: int = 0,
                 noise: float = 0.12) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images [n, H, W, 1] in [-1,1], labels [n] int32)."""
    assert domain in _FAMILIES, f"unknown domain {domain}"
    rng = np.random.default_rng(seed + _domain_salt(domain))
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    imgs = _FAMILIES[domain](labels, img_size, rng).astype(np.float32)
    imgs = imgs + rng.normal(0, noise, imgs.shape).astype(np.float32)
    imgs = np.clip(imgs, -1.0, 1.0)[..., None]
    return imgs, labels


def make_class_balanced(domain: str, per_class: int, *, img_size: int = 28,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed + 7 + _domain_salt(domain))
    labels = np.repeat(np.arange(NUM_CLASSES, dtype=np.int32), per_class)
    imgs = _FAMILIES[domain](labels, img_size, rng).astype(np.float32)
    imgs = imgs + rng.normal(0, 0.12, imgs.shape).astype(np.float32)
    return np.clip(imgs, -1.0, 1.0)[..., None], labels
