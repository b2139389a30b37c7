"""Whisper-tiny — encoder-decoder with conv/mel frontend stubbed
[arXiv:2212.04356]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", arch_type="audio", n_layers=4, d_model=384,
    n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, head_dim=64,
    mlp_variant="gelu", norm="layernorm", dense_bias=True,
    is_encoder_decoder=True, n_enc_layers=4, max_target_len=448,
    frontend="audio", num_prefix_embeds=1500,  # 30s @ 50 frames/s
    tie_embeddings=True, rope_theta=10000.0,
    citation="arXiv:2212.04356",
    notes="Mel+conv frontend stubbed: input_specs() supplies frame "
          "embeddings [B, frames, d_model]. Decoder self-attn uses "
          "absolute positions bounded by max_target_len=448; long_500k "
          "skipped (architectural position cap, see DESIGN.md).")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, head_dim=32, d_ff=256, vocab=256,
        num_prefix_embeds=32, max_target_len=64, param_dtype="float32")
