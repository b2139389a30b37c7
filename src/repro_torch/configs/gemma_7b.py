"""Gemma-7B — GeGLU MLP, head_dim 256 [arXiv:2403.08295]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", arch_type="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv_heads=16, d_ff=24576, vocab=256000, head_dim=256,
    mlp_variant="geglu", tie_embeddings=True,
    long_context_variant="swa",
    citation="arXiv:2403.08295",
    notes="MHA on 7b (kv=16); the 2b sibling uses MQA. GeGLU FFN, "
          "256k vocab dominates memory -> vocab sharded over model axis.")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=512, vocab=512, param_dtype="float32")
