"""RecurrentGemma-2B (Griffin) — RG-LRU recurrent blocks + local
attention in a 2:1 pattern [arXiv:2402.19427]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", arch_type="hybrid", n_layers=26,
    d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000,
    head_dim=256, mlp_variant="geglu",
    block_pattern=("rglru", "rglru", "local_attn"), local_window=2048,
    d_rnn=2560, tie_embeddings=True, supports_long_context=True,
    citation="arXiv:2402.19427",
    notes="1 local-attn : 2 RG-LRU blocks (Griffin). MQA (kv=1). "
          "long_500k decodes with O(1) recurrent state + 2048 window.")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=1,
        head_dim=32, d_ff=256, vocab=256, d_rnn=128, local_window=32,
        param_dtype="float32")
