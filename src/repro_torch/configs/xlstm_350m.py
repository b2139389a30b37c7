"""xLSTM-350M — alternating sLSTM and mLSTM blocks [arXiv:2405.04517]."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m", arch_type="ssm", n_layers=24, d_model=1024,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, head_dim=256,
    block_pattern=("slstm", "mlstm"), d_rnn=2048,
    tie_embeddings=True, supports_long_context=True,
    citation="arXiv:2405.04517",
    notes="d_ff=0: xLSTM blocks carry their own up/down projections. "
          "Attention-free; long_500k decodes with O(1) state.")


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        head_dim=64, d_rnn=256, vocab=256, param_dtype="float32")
