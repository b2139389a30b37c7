"""LLaVA-NeXT 34B language backbone — anyres vision tiling feeds
precomputed patch embeddings (frontend stubbed per the carve-out)
[hf:llava-hf/llava-v1.6-mistral-7b-hf]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", arch_type="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128,
    mlp_variant="swiglu", rope_theta=5e6, tie_embeddings=False,
    frontend="vision", num_prefix_embeds=2880,  # anyres: 5 tiles x 576
    long_context_variant="swa",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    notes="Vision tower + projector stubbed: input_specs() supplies "
          "[B, 2880, d_model] patch embeddings (anyres 5-tile grid).")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256, num_prefix_embeds=16,
        param_dtype="float32")
