"""Input stand-ins for every (arch x input-shape) pair (port of
``repro.launch.input_specs``).

The stand-ins are meta tensors: a shape and a dtype, no storage, so a
dry run of a full-size configuration allocates nothing. Token ids are
``int32``, frame and patch embeddings ``bfloat16``, as in the reference.
Semantics per family:

 * dense/moe/hybrid/ssm — tokens [B, S] (train/prefill); decode shapes
   supply a single token [B] plus a context-length cache.
 * vlm  — ``num_prefix_embeds`` patch embeddings [B, P, D] (frontend
   stub) followed by text tokens [B, S-P]; the total context is S.
 * audio (whisper, enc-dec) — encoder frame embeddings [B, S, D] (mel +
   conv stub); decoder tokens bounded by ``max_target_len``. "Sequence
   length" counts encoder frames.
 * long_500k on pure full-attention archs uses the sliding-window
   variant (``force_window``), as DESIGN.md's decode-shape notes say.

The decode cache is ``transformer.init_cache(..., device="meta")``: the
reference's ``jax.eval_shape`` tree, leaf for leaf (``repro_torch.bridge``
moves LM caches across without a transposition), except ``length``,
which the port keeps as a Python int where the reference has an int32
scalar.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, InputShape, INPUT_SHAPES
from repro_torch.models import transformer as T

SWA_FALLBACK_WINDOW = 4096


def decode_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """force_window to apply for this (arch, shape), None = arch default."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        if cfg.long_context_variant == "swa":
            return SWA_FALLBACK_WINDOW
    return None


def skip_reason(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """Return a reason string if this pair is skipped (DESIGN.md notes)."""
    if shape.kind == "decode" and cfg.arch_type == "gan":
        return "GAN has no autoregressive decode step"
    if shape.name == "long_500k":
        if cfg.is_encoder_decoder:
            return ("whisper positional/architectural cap (max 30s windows; "
                    "448-token decoder) — skipped per DESIGN.md")
        if not cfg.supports_long_context and cfg.long_context_variant is None:
            return "pure full attention, no sub-quadratic variant"
    return None


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: InputShape
                      ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        S_dec = cfg.max_target_len
        return {"tokens": _struct((B, S_dec), torch.int32),
                "labels": _struct((B, S_dec), torch.int32),
                "enc_frames": _struct((B, S, cfg.d_model), torch.bfloat16)}
    if cfg.frontend == "vision":
        P = min(cfg.num_prefix_embeds, S // 2)
        return {"tokens": _struct((B, S - P), torch.int32),
                "labels": _struct((B, S - P), torch.int32),
                "prefix_embeds": _struct((B, P, cfg.d_model),
                                         torch.bfloat16)}
    return {"tokens": _struct((B, S), torch.int32),
            "labels": _struct((B, S), torch.int32)}


def prefill_specs(cfg: ArchConfig, shape: InputShape
                  ) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {"tokens": _struct((B, cfg.max_target_len // 2), torch.int32),
                "enc_frames": _struct((B, S, cfg.d_model), torch.bfloat16)}
    if cfg.frontend == "vision":
        P = min(cfg.num_prefix_embeds, S // 2)
        return {"tokens": _struct((B, S - P), torch.int32),
                "prefix_embeds": _struct((B, P, cfg.d_model),
                                         torch.bfloat16)}
    return {"tokens": _struct((B, S), torch.int32)}


def decode_specs(cfg: ArchConfig, shape: InputShape
                 ) -> Tuple[torch.Tensor, Any]:
    """Returns (token [B], cache tree with a ctx_len context)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        # self-attn cache bounded by the decoder cap; cross cache = S frames
        cache = T.init_cache(cfg, B, cfg.max_target_len, device="meta")
        hd = cfg.resolved_head_dim
        for entry in cache["scanned"].values():
            n_sup = entry["xk"].shape[0]
            entry["xk"] = _struct((n_sup, B, S, cfg.n_kv_heads, hd),
                                  cfg.dtype)
            entry["xv"] = _struct((n_sup, B, S, cfg.n_kv_heads, hd),
                                  cfg.dtype)
    else:
        cache = T.init_cache(cfg, B, S, force_window=decode_window(cfg, shape),
                             device="meta")
    return _struct((B,), torch.int32), cache


def input_specs(cfg: ArchConfig, shape_name: Union[str, InputShape]
                ) -> Dict[str, Any]:
    """The stand-ins of one input shape, given by its name in
    ``INPUT_SHAPES`` or as an ``InputShape``."""
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    if shape.kind == "train":
        return {"kind": "train", "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"kind": "prefill", "batch": prefill_specs(cfg, shape)}
    token, cache = decode_specs(cfg, shape)
    return {"kind": "decode", "token": token, "cache": cache,
            "force_window": decode_window(cfg, shape)}
