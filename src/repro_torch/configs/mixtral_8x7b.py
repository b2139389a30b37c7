"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", arch_type="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, head_dim=128,
    n_experts=8, moe_top_k=2, sliding_window=4096, mlp_variant="swiglu",
    rope_theta=1e6, tie_embeddings=False,
    supports_long_context=True,   # SWA bounds the KV cache
    citation="arXiv:2401.04088",
    notes="SWA window 4096 per the paper; experts TP-sharded over d_ff "
          "(8 experts do not divide the 16-way model axis).")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256, n_experts=4, moe_top_k=2,
        sliding_window=64, param_dtype="float32")
