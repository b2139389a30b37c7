"""Command R+ 104B — dense GQA, no biases
[hf:CohereForAI/c4ai-command-r-v01]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", arch_type="dense", n_layers=64,
    d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000,
    head_dim=128, mlp_variant="swiglu", dense_bias=False,
    tie_embeddings=True, long_context_variant="swa",
    rope_theta=75e5,
    citation="hf:CohereForAI/c4ai-command-r-v01",
    notes="104B: params+Adam demand full FSDP+TP sharding; the dry-run "
          "proves fit on 256 chips (see EXPERIMENTS.md).")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        head_dim=32, d_ff=512, vocab=512, param_dtype="float32")
