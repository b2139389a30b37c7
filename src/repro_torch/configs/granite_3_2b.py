"""IBM Granite 3.0 2B dense GQA [hf:ibm-granite/granite-3.0-2b-base]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", arch_type="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, head_dim=64,
    mlp_variant="swiglu", tie_embeddings=True,
    long_context_variant="swa",
    citation="hf:ibm-granite/granite-3.0-2b-base")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, vocab=256, param_dtype="float32")
