"""Config-composable transformer LM (port of ``repro.models.transformer``).

One block type per ``ArchConfig.block_pattern`` entry:
  attn / local_attn  — GQA + RoPE (+ sliding window), chunked attention
  rglru              — RecurrentGemma RG-LRU mixer
  mlstm / slstm      — xLSTM blocks
plus a dense or MoE FFN, a tied or untied vocab head, an optional
encoder (whisper) with cross-attention, and prefix embeddings (the
VLM's patch stub) before the text.

Parameters keep the reference's tree: ``blocks/p{j}_{kind}`` hold every
full super-block of ``len(block_pattern)`` layers stacked on a leading
axis, ``rest/r{i}_{kind}`` the layers left over, ``enc_blocks`` the
stacked encoder, ``lm_head`` an untied head. Where the reference scans
the stacked blocks (``lax.scan``) the port loops over the leading axis
(``unbind`` views, so the gradient of a stacked leaf is one stack of its
slices), and where it wraps a super-block in ``jax.checkpoint`` the port
uses ``torch.utils.checkpoint`` while gradients are on: recomputation in
the backward pass, the same numbers.

Serving: ``prefill`` builds the cache (ring-buffer KV for attention,
state for the recurrent blocks, the encoder's keys and values for
cross-attention) and ``decode_step`` advances it by one token. The
cache's ``length`` is a Python int, so decoding reads nothing back
from the card; ``decode_step`` writes the new token's keys, values and
states into the cache's tensors in place and returns the cache with
``length + 1``.

Low-precision configs (bf16) keep the reference's rounding points: the
embedding scale ``sqrt(d)`` in ``cfg.dtype``, projections and
``out_proj`` in the operand dtype, float32 results where the reference
asks for them (MLP and MoE products, the vocab head; ``nn.mm_f32``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import nn
from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (apply_rope, attn_init,
                                          chunked_attention, decode_attention,
                                          out_proj, qkv_proj)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.sharding.dtensor_ops import (embedding, fsdp_gather, pad,
                                              to_param_layout, whole,
                                              whole_dim, write_slot,
                                              write_state)
from repro_torch.sharding.policy import maybe_shard
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# norms / mlp
# ---------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, device, lead: Tuple[int, ...] = ()) -> Params:
    shape = tuple(lead) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, device=device, dtype=cfg.dtype)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, device=device, dtype=cfg.dtype)
    return p


def _norm_apply(cfg: ArchConfig, p, x):
    return (nn.layernorm_apply(p, x) if cfg.norm == "layernorm"
            else nn.rmsnorm_apply(p, x))


def mlp_init(cfg: ArchConfig, gen, device, lead: Tuple[int, ...] = ()
             ) -> Params:
    std = 1.0 / math.sqrt(cfg.d_model)
    lead = tuple(lead)
    p = {"wi": nn.normal_init(lead + (cfg.d_model, cfg.d_ff), std, gen,
                              device, cfg.dtype),
         "wo": nn.normal_init(lead + (cfg.d_ff, cfg.d_model),
                              1.0 / math.sqrt(cfg.d_ff), gen, device,
                              cfg.dtype)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["wg"] = nn.normal_init(lead + (cfg.d_model, cfg.d_ff), std, gen,
                                 device, cfg.dtype)
    return p


def mlp_apply(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gate and input products with float32 results, the output product
    in the operand dtype (as the reference's row-parallel matmul)."""
    hi = nn.mm_f32(x, p["wi"])
    if cfg.mlp_variant in ("swiglu", "geglu"):
        hg = nn.mm_f32(x, p["wg"])
        act = (F.silu(hg) if cfg.mlp_variant == "swiglu"
               else nn.gelu(hg)) * hi
    else:
        act = nn.gelu(hi)
    return (act.to(x.dtype) @ p["wo"]).to(x.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def init_block(cfg: ArchConfig, kind: str, gen, device, *,
               cross: bool = False, lead: Tuple[int, ...] = ()) -> Params:
    """One block's parameters; ``lead`` prepends stacking axes (the
    super-block axis of ``blocks``)."""
    dtype = cfg.dtype
    hd = cfg.resolved_head_dim
    p: Params = {"norm1": _norm_init(cfg, device, lead)}
    if kind in ("attn", "local_attn"):
        p["attn"] = attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                              gen, device, qkv_bias=cfg.qkv_bias,
                              dtype=dtype, lead=lead)
    elif kind == "rglru":
        p["rglru"] = rec.rglru_init(cfg.d_model, cfg.d_rnn or cfg.d_model,
                                    gen, device, dtype=dtype, lead=lead)
    elif kind == "mlstm":
        p["mlstm"] = rec.mlstm_init(cfg.d_model, cfg.n_heads, hd, gen,
                                    device, dtype=dtype, lead=lead)
    elif kind == "slstm":
        p["slstm"] = rec.slstm_init(cfg.d_model, cfg.d_rnn or cfg.d_model,
                                    gen, device, dtype=dtype, lead=lead)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_x"] = _norm_init(cfg, device, lead)
        p["xattn"] = attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd,
                               gen, device, dtype=dtype, lead=lead)
    if cfg.d_ff > 0:
        p["norm2"] = _norm_init(cfg, device, lead)
        if cfg.n_experts:
            p["moe"] = moe_init(cfg.d_model, cfg.d_ff, cfg.n_experts, gen,
                                device, mlp_variant=cfg.mlp_variant,
                                dtype=dtype, lead=lead)
        else:
            p["mlp"] = mlp_init(cfg, gen, device, lead)
    return p


def _window_for(cfg: ArchConfig, kind: str,
                force_window: Optional[int]) -> Optional[int]:
    if force_window is not None:
        return force_window
    if kind == "local_attn":
        return cfg.local_window
    return cfg.sliding_window


def _ffn(cfg: ArchConfig, p: Params, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The block's FFN residual: (new x, the MoE's aux losses or None;
    ``_moe_aux_loss`` combines them where the loss needs them, so the
    serving steps, which drop them, run no collective for them)."""
    h2 = maybe_shard(_norm_apply(cfg, p["norm2"], x), "resid_inner")
    if cfg.n_experts:
        o, moe_aux = moe_apply(p["moe"], h2, top_k=cfg.moe_top_k,
                               capacity_factor=cfg.capacity_factor,
                               mlp_variant=cfg.mlp_variant)
        return _residual(x, o), moe_aux
    return _residual(x, mlp_apply(cfg, p["mlp"], h2)), None


def _moe_aux_loss(moe_aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The aux losses' term, whole on every rank of a mesh."""
    return whole(moe_aux["load_balance"]) + 1e-3 * whole(moe_aux["router_z"])


def _residual(x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``x + o``, a sublayer's output laid out as the residual stream
    (``resid``) before it joins it, so that the gradient reaching the
    sublayer comes back in the sublayer's own layout (sequence whole),
    as the reference's partitioner lays out a sequence-parallel block."""
    return x + maybe_shard(o, "resid")


def _cross(cfg: ArchConfig, p: Params, x: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    hx = maybe_shard(_norm_apply(cfg, p["norm_x"], x), "resid_inner")
    q, _, _ = qkv_proj(p["xattn"], hx)
    return _residual(x, out_proj(p["xattn"],
                                 chunked_attention(q, k, v, causal=False)))


def block_seq(cfg: ArchConfig, kind: str, p: Params, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              enc_out: Optional[torch.Tensor] = None,
              force_window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward. Returns (x, moe_aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = maybe_shard(_norm_apply(cfg, p["norm1"], x), "resid_inner")
    if kind in ("attn", "local_attn"):
        q, k, v = qkv_proj(p["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = chunked_attention(q, k, v,
                              window=_window_for(cfg, kind, force_window),
                              causal=causal)
        x = _residual(x, out_proj(p["attn"], o))
    elif kind == "rglru":
        x = _residual(x, rec.rglru_seq(p["rglru"], h)[0])
    elif kind == "mlstm":
        x = _residual(x, rec.mlstm_seq(p["mlstm"], h)[0])
    elif kind == "slstm":
        x = _residual(x, rec.slstm_seq(p["slstm"], h)[0])
    if enc_out is not None and "xattn" in p:
        _, k, v = qkv_proj(p["xattn"], enc_out)
        x = _cross(cfg, p, x, k, v)
    if cfg.d_ff > 0:
        x, a = _ffn(cfg, p, x)
        if a is not None:
            aux = aux + _moe_aux_loss(a)
    return maybe_shard(x, "resid"), aux


# --- cache handling --------------------------------------------------------

def _attn_cache_len(cfg: ArchConfig, kind: str, ctx_len: int,
                    margin: int, force_window: Optional[int]) -> int:
    w = _window_for(cfg, kind, force_window)
    if w is not None:
        return min(ctx_len + margin, w)
    return ctx_len + margin


def init_cache_entry(cfg: ArchConfig, kind: str, batch: int, ctx_len: int,
                     *, margin: int = 16, force_window: Optional[int] = None,
                     device="cuda", lead: Tuple[int, ...] = ()) -> Params:
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    d_rnn = cfg.d_rnn or cfg.d_model
    lead = tuple(lead)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)
    if kind in ("attn", "local_attn"):
        s = _attn_cache_len(cfg, kind, ctx_len, margin, force_window)
        return {"k": zeros(batch, s, cfg.n_kv_heads, hd, dtype=cfg.dtype),
                "v": zeros(batch, s, cfg.n_kv_heads, hd, dtype=cfg.dtype)}
    if kind == "rglru":
        return {"h": zeros(batch, d_rnn)}
    if kind == "mlstm":
        return {"C": zeros(batch, cfg.n_heads, hd, hd),
                "n": zeros(batch, cfg.n_heads, hd)}
    if kind == "slstm":
        return {"c": zeros(batch, d_rnn), "n": zeros(batch, d_rnn),
                "m": torch.full(lead + (batch, d_rnn), -1e30,
                                dtype=torch.float32, device=device)}
    raise ValueError(kind)


def block_prefill(cfg: ArchConfig, kind: str, p: Params, x: torch.Tensor,
                  positions: torch.Tensor, ctx_len: int, *,
                  enc_out: Optional[torch.Tensor] = None, margin: int = 16,
                  force_window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Forward + the block's cache entry."""
    B, S = x.shape[0], x.shape[1]
    # laid out as the training forward lays its blocks out
    h = maybe_shard(_norm_apply(cfg, p["norm1"], x), "resid_inner")
    if kind in ("attn", "local_attn"):
        q, k, v = qkv_proj(p["attn"], h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = chunked_attention(q, k, v,
                              window=_window_for(cfg, kind, force_window))
        x = _residual(x, out_proj(p["attn"], o))
        s_cache = _attn_cache_len(cfg, kind, ctx_len, margin, force_window)
        keep = min(S, s_cache)
        k_keep = k[:, S - keep:].to(cfg.dtype)
        v_keep = v[:, S - keep:].to(cfg.dtype)
        if keep == s_cache and S % s_cache != 0:
            # ring discipline: token t lives at slot t % s_cache, so the
            # kept window [S-keep, S) starts at slot (S-keep) % s_cache
            shift = (S - keep) % s_cache
            k_keep = torch.roll(k_keep, shift, dims=1)
            v_keep = torch.roll(v_keep, shift, dims=1)
        # the kept keys and a zero tail (built from them, not written into
        # a zero buffer, so they keep the keys' layout across ranks)
        tail = (0, 0, 0, 0, 0, s_cache - keep)
        entry = {"k": pad(k_keep, tail), "v": pad(v_keep, tail)}
    elif kind == "rglru":
        o, hstate = rec.rglru_seq(p["rglru"], h)
        x = _residual(x, o)
        entry = {"h": hstate}
    elif kind == "mlstm":
        o, entry = rec.mlstm_seq(p["mlstm"], h)
        x = _residual(x, o)
    elif kind == "slstm":
        o, entry = rec.slstm_seq(p["slstm"], h)
        x = _residual(x, o)
    if enc_out is not None and "xattn" in p:
        _, kx, vx = qkv_proj(p["xattn"], enc_out)
        x = _cross(cfg, p, x, kx, vx)
        entry["xk"] = kx.to(cfg.dtype)
        entry["xv"] = vx.to(cfg.dtype)
    if cfg.d_ff > 0:
        x = _ffn(cfg, p, x)[0]
    entry = {k: maybe_shard(v, "cache") if v.ndim == 4 else v
             for k, v in entry.items()}
    return maybe_shard(x, "resid"), entry


def block_decode(cfg: ArchConfig, kind: str, p: Params, x: torch.Tensor,
                 entry: Params, length: int, *,
                 force_window: Optional[int] = None) -> torch.Tensor:
    """One-token step. x [B,1,D]; ``length`` tokens already in the cache.
    Writes the token's keys/values (ring slot ``length % s_max``) or the
    new recurrent state into ``entry``'s tensors in place; returns x.
    On a mesh the block takes the layout sites of ``block_prefill`` (the
    sublayer inputs ``resid_inner``, their outputs joining the residual
    stream as ``resid``), so no sum of partial products is left to
    DTensor's rules between sublayers."""
    h = maybe_shard(_norm_apply(cfg, p["norm1"], x), "resid_inner")
    if kind in ("attn", "local_attn"):
        q, k, v = qkv_proj(p["attn"], h)
        pos = torch.arange(length, length + 1, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        s_max = entry["k"].shape[1]
        idx = length % s_max
        write_slot(entry["k"], idx, k[:, 0])
        write_slot(entry["v"], idx, v[:, 0])
        o = decode_attention(q, entry["k"], entry["v"],
                             min(length + 1, s_max))
        x = _residual(x, out_proj(p["attn"], o))
    elif kind == "rglru":
        o, hs = rec.rglru_step(p["rglru"], h, entry["h"])
        x = _residual(x, o)
        write_state(entry["h"], hs)
    else:
        names = ("C", "n") if kind == "mlstm" else ("c", "n", "m")
        step = rec.mlstm_step if kind == "mlstm" else rec.slstm_step
        o, st = step(p[kind], h, {n: entry[n] for n in names})
        x = _residual(x, o)
        for n in names:
            write_state(entry[n], st[n])
    if "xk" in entry and "xattn" in p:
        hx = maybe_shard(_norm_apply(cfg, p["norm_x"], x), "resid_inner")
        q, _, _ = qkv_proj(p["xattn"], hx)
        o = decode_attention(q, entry["xk"], entry["xv"],
                             entry["xk"].shape[1])
        x = _residual(x, out_proj(p["xattn"], o))
    if cfg.d_ff > 0:
        x = _ffn(cfg, p, x)[0]
    return maybe_shard(x, "resid")


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _pattern_split(cfg: ArchConfig) -> Tuple[int, Tuple[str, ...]]:
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    rem = cfg.n_layers - n_super * len(pat)
    return n_super, tuple(pat[i] for i in range(rem))


def unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` slices of a tree stacked on its leading axis, as views
    (one ``unbind`` per leaf)."""
    parts = tree_map(lambda x: whole_dim(x, 0).unbind(0), tree)
    return [tree_map(lambda u, i=i: u[i], parts) for i in range(n)]


def init_lm(cfg: ArchConfig, gen: torch.Generator, device="cuda") -> Params:
    """Random LM parameters in the reference's tree, drawn from ``gen``
    on the generator's device and stored on ``device`` (default the
    card; asking for it without CUDA raises)."""
    device = resolve_device(device)
    params: Params = {
        "embed": nn.embedding_table_init(cfg.vocab, cfg.d_model, gen, device,
                                         cfg.dtype),
        "final_norm": _norm_init(cfg, device),
    }
    cross = cfg.is_encoder_decoder
    n_super, rest = _pattern_split(cfg)
    params["blocks"] = {
        f"p{j}_{kind}": init_block(cfg, kind, gen, device, cross=cross,
                                   lead=(n_super,))
        for j, kind in enumerate(cfg.block_pattern)}
    params["rest"] = {f"r{i}_{kind}": init_block(cfg, kind, gen, device,
                                                 cross=cross)
                      for i, kind in enumerate(rest)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": nn.normal_init(
            (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), gen,
            device, cfg.dtype)}
    if cfg.is_encoder_decoder:
        params["enc_blocks"] = init_block(cfg, "attn", gen, device,
                                          lead=(cfg.n_enc_layers,))
        params["enc_norm"] = _norm_init(cfg, device)
    return params


def _embed_scale(cfg: ArchConfig) -> float:
    """sqrt(d_model) rounded to ``cfg.dtype``, as the reference scales."""
    return float(torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype))


def _embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    x = embedding(tokens.long(), fsdp_gather(params["embed"])["table"])
    x = x.to(cfg.dtype) * _embed_scale(cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    return maybe_shard(x, "resid")


def _logits(cfg: ArchConfig, params: Params, x: torch.Tensor
            ) -> torch.Tensor:
    """Final norm and the vocab head; float32 logits."""
    params = fsdp_gather({k: params[k] for k in ("final_norm", "embed",
                                                  "lm_head") if k in params})
    x = maybe_shard(_norm_apply(cfg, params["final_norm"], x), "resid_inner")
    if cfg.tie_embeddings:
        logits = nn.embedding_attend(params["embed"], x)
    else:
        logits = nn.mm_f32(x, params["lm_head"]["w"])
    return maybe_shard(logits, "logits")


def _remat(fn, x: torch.Tensor):
    """``fn(x)``, recomputed in the backward pass when gradients are on
    (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(x)


def _encoder(cfg: ArchConfig, params: Params,
             frames: torch.Tensor) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings [B, S_enc, D]."""
    x = frames.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    for p in unstack(params["enc_blocks"], cfg.n_enc_layers):
        x = _remat(lambda x_, p=p: block_seq(cfg, "attn", fsdp_gather(p), x_,
                                             pos, causal=False)[0], x)
    # the decoder's cross-attention projects every frame
    return maybe_shard(_norm_apply(cfg, fsdp_gather(params["enc_norm"]), x),
                       "resid_inner")


def forward_train(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor] = None,
                  enc_frames: Optional[torch.Tensor] = None,
                  force_window: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, S_total, V] float32, moe_aux)."""
    enc_out = (_encoder(cfg, params, enc_frames)
               if cfg.is_encoder_decoder else None)
    x = _embed(cfg, params, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    pattern = cfg.block_pattern
    n_super, rest = _pattern_split(cfg)

    def superblock(x, slice_p):
        # gathered inside the recomputed region: one super-block's
        # weights whole at a time, gathered again in the backward pass
        slice_p = fsdp_gather(slice_p)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, kind in enumerate(pattern):
            x, a = block_seq(cfg, kind, slice_p[f"p{j}_{kind}"], x,
                             positions, enc_out=enc_out,
                             force_window=force_window)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for slice_p in unstack(params["blocks"], n_super):
        x, a = _remat(lambda x_, sp=slice_p: superblock(x_, sp), x)
        aux = aux + a
    for i, kind in enumerate(rest):
        x, a = block_seq(cfg, kind,
                         fsdp_gather(params["rest"][f"r{i}_{kind}"]), x,
                         positions, enc_out=enc_out,
                         force_window=force_window)
        aux = aux + a
    return _logits(cfg, params, x), aux


def token_nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-logp`` at each label: ``[..., V]``, ``[...]`` -> ``[...]``.
    ``nll_loss`` picks the entries a gather would (the reference's
    ``take_along_axis``), bit for bit; DTensor has a batch-sharded rule
    for it, where a gather's backward builds a zero tensor of the global
    shape on every rank."""
    return F.nll_loss(logp.reshape(-1, logp.shape[-1]), labels.reshape(-1),
                      reduction="none").view(labels.shape)


def lm_loss(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor],
            force_window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the text (the labels cover the suffix
    after any prefix embeddings) plus 1e-2 times the MoE aux loss."""
    logits, aux = forward_train(
        cfg, params, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"),
        enc_frames=batch.get("enc_frames"), force_window=force_window)
    labels = batch["labels"].long()
    logits_txt = logits[:, -labels.shape[1]:]
    logp = torch.log_softmax(logits_txt.float(), dim=-1)
    nll = token_nll(logp, labels)
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + 1e-2 * aux, {"nll": loss, "moe_aux": aux}


def value_and_grad(loss_fn, params: Params):
    """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)``; a leaf
    the loss does not reach gets a zero gradient, as in JAX."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    flat = tree_leaves(leaves)
    with torch.enable_grad():
        loss, aux = loss_fn(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(x): torch.zeros_like(x) if g is None else g
             for x, g in zip(flat, grads)}
    return loss.detach(), aux, tree_map(lambda x: by_id[id(x)], leaves)


def make_train_step(cfg: ArchConfig, optimizer,
                    force_window: Optional[int] = None):
    """(train_step, opt_init); ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, metrics as 0-dim device tensors."""
    opt_init, opt_update = optimizer

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(
            lambda p: lm_loss(cfg, p, batch, force_window), params)
        # on a mesh: each gradient on its parameter's shards
        grads = to_param_layout(grads, params)
        opt_state, params = opt_update(opt_state, grads, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss)

    return train_step, opt_init


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, ctx_len: int, *,
               margin: int = 16, force_window: Optional[int] = None,
               device="cuda") -> Params:
    device = resolve_device(device)
    n_super, rest = _pattern_split(cfg)
    scanned = {}
    for j, kind in enumerate(cfg.block_pattern):
        e = init_cache_entry(cfg, kind, batch, ctx_len, margin=margin,
                             force_window=force_window, device=device,
                             lead=(n_super,))
        if cfg.is_encoder_decoder:
            shape = (n_super, batch, cfg.num_prefix_embeds, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            e["xk"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
            e["xv"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        scanned[f"p{j}_{kind}"] = e
    rest_cache = {f"r{i}_{kind}": init_cache_entry(
        cfg, kind, batch, ctx_len, margin=margin, force_window=force_window,
        device=device) for i, kind in enumerate(rest)}
    return {"scanned": scanned, "rest": rest_cache, "length": 0}


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None, *,
            margin: int = 16, force_window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Returns (last-position logits [B, V] float32, cache)."""
    enc_out = (_encoder(cfg, params, enc_frames)
               if cfg.is_encoder_decoder else None)
    x = _embed(cfg, params, tokens, prefix_embeds)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)
    n_super, rest = _pattern_split(cfg)
    entries: Dict[str, List[Params]] = {
        f"p{j}_{kind}": [] for j, kind in enumerate(cfg.block_pattern)}
    for slice_p in unstack(params["blocks"], n_super):
        slice_p = fsdp_gather(slice_p)
        for j, kind in enumerate(cfg.block_pattern):
            name = f"p{j}_{kind}"
            x, e = block_prefill(cfg, kind, slice_p[name], x, positions, S,
                                 enc_out=enc_out, margin=margin,
                                 force_window=force_window)
            entries[name].append(e)
    if n_super:
        scanned = {name: {k: torch.stack([e[k] for e in es])
                          for k in es[0]} for name, es in entries.items()}
    else:
        scanned = init_cache(cfg, B, S, margin=margin,
                             force_window=force_window,
                             device=x.device)["scanned"]
    rest_cache = {}
    for i, kind in enumerate(rest):
        x, e = block_prefill(cfg, kind,
                             fsdp_gather(params["rest"][f"r{i}_{kind}"]), x,
                             positions, S, enc_out=enc_out, margin=margin,
                             force_window=force_window)
        rest_cache[f"r{i}_{kind}"] = e
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0], {"scanned": scanned, "rest": rest_cache,
                          "length": S}


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                cache: Params, *, force_window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
    """token [B] or [B,1] -> (logits [B, V] float32, cache advanced by
    one token: its tensors updated in place, ``length + 1``)."""
    if token.ndim == 1:
        token = token[:, None]
    x = embedding(token.long(), fsdp_gather(params["embed"])["table"])
    x = maybe_shard(x.to(cfg.dtype) * _embed_scale(cfg), "resid")
    length = cache["length"]
    n_super, rest = _pattern_split(cfg)
    slices_c = unstack(cache["scanned"], n_super)
    for slice_p, slice_c in zip(unstack(params["blocks"], n_super), slices_c):
        slice_p = fsdp_gather(slice_p)
        for j, kind in enumerate(cfg.block_pattern):
            name = f"p{j}_{kind}"
            x = block_decode(cfg, kind, slice_p[name], x, slice_c[name],
                             length, force_window=force_window)
    for i, kind in enumerate(rest):
        name = f"r{i}_{kind}"
        x = block_decode(cfg, kind, fsdp_gather(params["rest"][name]), x,
                         cache["rest"][name], length,
                         force_window=force_window)
    logits = _logits(cfg, params, x)
    return logits[:, 0], {"scanned": cache["scanned"], "rest": cache["rest"],
                          "length": length + 1}
