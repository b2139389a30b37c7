"""Qwen1.5-4B — dense GQA with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", arch_type="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936, head_dim=128,
    qkv_bias=True, mlp_variant="swiglu", tie_embeddings=True,
    long_context_variant="swa",
    citation="hf:Qwen/Qwen1.5-0.5B")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=256, param_dtype="float32")
