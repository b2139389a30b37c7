"""Synthetic token streams for LM training/serving examples (numpy copy
of ``repro.data.tokens``: the same streams per seed, byte for byte).

Zipf-distributed unigrams mixed with short copy/repeat motifs so a small
LM has learnable structure. Deterministic per (seed, vocab).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int,
                alpha: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(vocab, size=n, p=p).astype(np.int32)


def lm_batches(vocab: int, batch: int, seq_len: int, *, seed: int = 0,
               motif_len: int = 16) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (tokens [B,S], labels [B,S]) forever; labels are next-token."""
    rng = np.random.default_rng(seed)
    while True:
        toks = zipf_tokens(rng, batch * (seq_len + 1), vocab).reshape(
            batch, seq_len + 1)
        # inject copy motifs: second half repeats a window from first half
        for i in range(batch):
            if rng.random() < 0.5 and seq_len > 2 * motif_len:
                start = rng.integers(0, seq_len // 2 - motif_len)
                dst = rng.integers(seq_len // 2, seq_len - motif_len)
                toks[i, dst: dst + motif_len] = toks[i, start: start + motif_len]
        yield toks[:, :-1], toks[:, 1:]
