"""Attention (port of ``repro.models.attention``): RoPE, the GQA
projections, chunked causal / sliding-window / full attention for
training and prefill, one-token decode attention, and the ring-buffer
``KVCache``.

Layouts are the reference's: ``wq/wk/wv [d, n, hd]``, ``wo [n, hd, d]``,
optional biases ``bq [n, hd]``, ``bk/bv [kv, hd]``; activations
``x [B, S, d]``, heads ``[B, S, N, hd]``. The split LM server
(``launch.serve_split``) runs its attention through the kernels
``kernels.ops.mem_attention`` / ``flash_decode``; the monolithic LM
(``models.transformer``) runs ``chunked_attention`` and
``decode_attention`` below, plain torch in float32, as the reference
runs its plain ``jnp`` versions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.sharding import dtensor_ops

NEG_INF = -1e30


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: a tensor made from theta on the card would be
    # a synchronous host copy on every call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, N, hd]; positions [B, S] or [S]. Half-split rotation:
    the first and second halves of ``hd`` are the pair's two parts (not
    interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs               # [B, S, hd/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def attn_init(d_model: int, n_heads: int, n_kv: int, head_dim: int, gen,
              device, *, qkv_bias: bool = False, dtype=torch.float32,
              lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Normal weights with std 1/sqrt(d_model), and 1/sqrt(2) of that for
    the output projection, drawn from ``gen`` on its device; zero
    biases with ``qkv_bias``. ``lead`` prepends stacking axes (one set
    of weights per leading index)."""
    std = 1.0 / math.sqrt(d_model)

    def normal(shape, s):
        x = torch.randn(lead + shape, generator=gen, device=gen.device) * s
        return x.to(device=device, dtype=dtype)
    p = {"wq": normal((d_model, n_heads, head_dim), std),
         "wk": normal((d_model, n_kv, head_dim), std),
         "wv": normal((d_model, n_kv, head_dim), std),
         "wo": normal((n_heads, head_dim, d_model), std / math.sqrt(2.0))}
    if qkv_bias:
        for name, n in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros(lead + (n, head_dim), device=device,
                                  dtype=dtype)
    return p


def qkv_proj(p: Dict[str, torch.Tensor], x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections in ``x``'s dtype (float32 accumulation), then the
    biases where the weights have them."""
    def proj(w):
        # [d, n, hd] as one [d, n*hd] product (the heads outermost, so a
        # head-sharded DTensor weight flattens without a redistribution)
        n, hd = w.shape[-2], w.shape[-1]
        y = x @ w.reshape(x.shape[-1], n * hd)
        return y.reshape(*x.shape[:-1], n, hd)
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def out_proj(p: Dict[str, torch.Tensor], o: torch.Tensor) -> torch.Tensor:
    """o [b, s, n, hd] @ wo [n, hd, d], as one [n*hd, d] product."""
    n, hd, d = p["wo"].shape
    w = p["wo"].to(o.dtype).reshape(n * hd, d)
    return o.reshape(*o.shape[:-2], n * hd) @ w


# ---------------------------------------------------------------------------
# chunked attention (training / prefill)
# ---------------------------------------------------------------------------

def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """[Sq, Sk] True where attendable (causal + optional sliding window)."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


@dtensor_ops.local_heads
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: Optional[int] = None, q_chunk: int = 512,
                      k_chunk: int = 512, causal: bool = True
                      ) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,S_kv,KV,hd] -> [B,S,H,hd], in float32.

    GQA by head grouping (query head h reads kv head h // (H/KV)).
    Queries go ``q_chunk`` at a time, each against the keys its mask can
    reach (causal: up to the chunk's last position; with a window: from
    ``window - 1`` before its first), so no ``[B, H, S, S]`` tensor is
    built. Those keys go ``k_chunk`` at a time on the reference's grid
    (multiples of ``k_chunk``, each chunk cut to the reachable range)
    with an online softmax: a running maximum, and the sums and the
    output rescaled by ``exp(old max - new max)``; with ``k_chunk`` at
    least the reachable range it is one softmax over all of it.
    Masked scores are ``NEG_INF`` and their weights exactly 0, and the
    denominator is clamped at 1e-30, so a row with nothing to attend
    comes out as zeros. DTensors run per rank
    (``dtensor_ops.local_heads``)."""
    B, S, H, hd = q.shape
    S_kv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(B, S, KV, G, hd)
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, S, q_chunk):
        q1 = min(q0 + q_chunk, S)
        k0, k1 = 0, S_kv
        if causal:
            k1 = min(q1, S_kv)
            if window is not None:
                k0 = max(0, q0 - window + 1)
        # acc [B,q,KV,G,hd], den [B,q,KV,G,1], running max m [B,KV,G,q,1]
        acc = den = m = None
        for c0 in range(k0 - k0 % k_chunk, k1, k_chunk):
            a, b = max(c0, k0), min(c0 + k_chunk, k1)
            s = torch.einsum("bqkgh,bckh->bkgqc", qf[:, q0:q1],
                             kf[:, a:b]) * scale
            if causal:
                mask = _chunk_mask(torch.arange(q0, q1, device=q.device),
                                   torch.arange(a, b, device=q.device),
                                   window)
                s = torch.where(mask, s, NEG_INF)
            blk = s.amax(-1, keepdim=True)
            new_m = blk if m is None else torch.maximum(m, blk)
            p = torch.exp(s - new_m)
            if causal:
                p = torch.where(mask, p, 0.0)
            o = torch.einsum("bkgqc,bckh->bqkgh", p, vf[:, a:b])
            d = p.sum(-1).permute(0, 3, 1, 2)[..., None]
            if m is None:
                acc, den = o, d
            else:
                corr = torch.exp(m - new_m).permute(0, 3, 1, 2, 4)
                acc = acc * corr + o
                den = den * corr + d
            m = new_m
        outs.append(acc / torch.clamp(den, min=1e-30))
    out = torch.cat(outs, 1) if len(outs) > 1 else outs[0]
    return out.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention (one new token vs a cache)
# ---------------------------------------------------------------------------

@dtensor_ops.split_cache_decode
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q [B,1,H,hd]; caches [B,S,KV,hd]; ``cache_len`` an int (every row)
    or an int tensor [B]: the slots before it are valid. Full softmax
    over the masked cache, in float32. DTensor caches go through
    ``dtensor_ops.decode_over_shards``."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qh = q.float().reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    if isinstance(cache_len, torch.Tensor) and cache_len.ndim == 1:
        valid = pos[None, :] < cache_len[:, None]
    else:
        valid = (pos < cache_len)[None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


@dataclasses.dataclass
class KVCache:
    """Ring-buffer KV cache (bounded by the window for SWA archs).
    ``length`` counts the tokens seen, as a Python int, so appending
    never reads the card."""
    k: torch.Tensor   # [B, S_max, KV, hd]
    v: torch.Tensor
    length: int = 0

    @staticmethod
    def zeros(batch: int, s_max: int, n_kv: int, head_dim: int,
              dtype=torch.bfloat16, device="cuda") -> "KVCache":
        device = resolve_device(device)
        shape = (batch, s_max, n_kv, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Append one token (k_new [B,1,KV,hd]) at ring slot
        ``length % S_max``; returns a new cache."""
        idx = self.length % self.k.shape[1]
        k, v = self.k.clone(), self.v.clone()
        k[:, idx] = k_new[:, 0].to(k.dtype)
        v[:, idx] = v_new[:, 0].to(v.dtype)
        return KVCache(k, v, self.length + 1)
