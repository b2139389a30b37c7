"""IBM Granite 3.0 1B-A400M — 32-expert top-8 fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", arch_type="moe", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155,
    head_dim=64, n_experts=32, moe_top_k=8, mlp_variant="swiglu",
    tie_embeddings=True, long_context_variant="swa",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="32 experts divide the 16-way model axis -> expert-parallel "
          "sharding (2 experts/chip) with GSPMD all-to-all.")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=64, vocab=256, n_experts=4, moe_top_k=2,
        param_dtype="float32")
