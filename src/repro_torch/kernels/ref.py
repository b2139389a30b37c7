"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).
The wrappers take them for tensors on the CPU; on the card they are what
each kernel is checked against."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30         # the masked-score fill of the reference (not -inf)


def clustered_agg_ref(weights: torch.Tensor, stacked: torch.Tensor
                      ) -> torch.Tensor:
    """out[s] = sum_k W[s, k] x[k] in float32: weights [S, K] (one
    normalized row per aggregation segment), stacked [K, ...]. Weights
    come first (matmul order ``W @ theta``)."""
    flat = stacked.reshape(stacked.shape[0], -1).float()
    out = weights.float() @ flat
    return out.reshape((weights.shape[0],) + stacked.shape[1:])


def kmeans_assign_ref(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centre assignment: x [N, D], centers [M, D] -> labels [N]
    int32, ties to the lowest index."""
    x, c = x.float(), centers.float()
    d2 = ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T
          + (c * c).sum(-1)[None, :])
    return torch.argmin(d2, dim=1).to(torch.int32)


def mem_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lens: torch.Tensor, causal: bool = True
                      ) -> torch.Tensor:
    """Full prefill GQA attention with dense float32 scores: q [B, S, H,
    hd], k/v [B, S, KV, hd], lens [B] int (keys at or past a row's length
    are masked) -> [B, S, H, hd]. Query head h reads kv head
    h // (H // KV)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qh, k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] < lens.to(q.device)[:, None]
    mask = mask[:, None, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])[None, None, None]
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """One query token against a KV cache: q [B, H, hd], k/v [B, S, KV,
    hd], cache_len a scalar (int or one-element tensor); positions at or
    past it are masked -> [B, H, hd]."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qh, k.float()) / math.sqrt(hd)
    clen = (cache_len.to(q.device).reshape(()) if isinstance(
        cache_len, torch.Tensor) else int(cache_len))
    valid = torch.arange(S, device=q.device) < clen
    p = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cache_len, n_splits: int) -> torch.Tensor:
    """``flash_decode_ref`` computed as the split kernel computes it: the
    valid rows [0, len) cut into ``n_splits`` pieces of ceil(len /
    n_splits) rows, each piece's (max m, denominator l, accumulator acc)
    taken alone (an empty piece gives m = -1e30, l = 0), then combined:
    out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    clen = min(max(int(cache_len), 0), S)
    per = -(-clen // n_splits)
    qh = q.reshape(B, KV, G, hd).float()
    ms, ls, accs = [], [], []
    for i in range(n_splits):
        r0, r1 = min(i * per, clen), min((i + 1) * per, clen)
        s = torch.einsum("bkgh,bskh->bkgs", qh,
                         k[:, r0:r1].float()) / math.sqrt(hd)
        m = (s.amax(-1) if r1 > r0 else
             torch.full((B, KV, G), NEG_INF, device=q.device))
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bskh->bkgh", p, v[:, r0:r1].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))
    l = (torch.stack(ls) * w).sum(0)
    acc = (torch.stack(accs) * w[..., None]).sum(0)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)
