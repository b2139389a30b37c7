"""Generation-quality metrics (paper §5).

* `dataset_score` — the MD-GAN-style Inception-Score analogue using a
  dataset-specific classifier instead of InceptionV3 (paper metric 2a).
* `fid` — Fréchet distance between feature Gaussians (paper metric 2b),
  computed with the eval CNN's penultimate features.

A copy of ``repro.metrics.scores``, which is numpy only.
"""
from __future__ import annotations

import numpy as np


def dataset_score(probs: np.ndarray, eps: float = 1e-12) -> float:
    """exp(E_x KL(p(y|x) || p(y))) over classifier predictive probs [N, C]."""
    p_y = probs.mean(0, keepdims=True)
    kl = probs * (np.log(probs + eps) - np.log(p_y + eps))
    return float(np.exp(kl.sum(1).mean()))


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a symmetric PSD matrix via eigendecomposition."""
    w, v = np.linalg.eigh((mat + mat.T) / 2.0)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)) @ v.T


def fid(feat_real: np.ndarray, feat_fake: np.ndarray) -> float:
    """Fréchet distance between N(mu_r, C_r) and N(mu_f, C_f)."""
    mu_r, mu_f = feat_real.mean(0), feat_fake.mean(0)
    c_r = np.cov(feat_real, rowvar=False)
    c_f = np.cov(feat_fake, rowvar=False)
    diff = mu_r - mu_f
    # trace of the geometric-mean term via sqrt(C_r) C_f sqrt(C_r), PSD-safe
    s_r = _sqrtm_psd(c_r)
    inner = _sqrtm_psd(s_r @ c_f @ s_r)
    return float(diff @ diff + np.trace(c_r) + np.trace(c_f) - 2 * np.trace(inner))
