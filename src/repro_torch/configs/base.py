"""Architecture config system (port of ``repro.configs.base``; the
configs are the reference's, shapes only, with ``dtype`` a torch dtype).

Every assigned architecture is one `ArchConfig` in its own module (per
spec), registered under its public id for `--arch <id>` selection. Each
module also provides a `smoke()` reduced variant (<=2 layers, d_model
<=512, <=4 experts) for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                     # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""
    head_dim: Optional[int] = None
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # attention details
    sliding_window: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_variant: str = "swiglu"        # swiglu|geglu|gelu
    norm: str = "rmsnorm"              # rmsnorm|layernorm
    dense_bias: bool = False
    tie_embeddings: bool = True
    # layer pattern, cycled: entries in {attn, local_attn, rglru, mlstm, slstm}
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048           # window for local_attn pattern entries
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    max_target_len: int = 0
    # modality frontend stub
    frontend: Optional[str] = None     # vision|audio
    num_prefix_embeds: int = 0         # patch/frame embeddings per example
    # recurrent dims
    d_rnn: Optional[int] = None
    # long-context applicability
    supports_long_context: bool = False   # natively sub-quadratic
    long_context_variant: Optional[str] = None  # e.g. 'swa' fallback
    # dtypes
    param_dtype: str = "bfloat16"
    # notes for DESIGN.md
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dtype(self):
        return (torch.bfloat16 if self.param_dtype == "bfloat16"
                else torch.float32)

    def pattern_for_layer(self, i: int) -> str:
        return self.block_pattern[i % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (sanity/rooline: 6ND model flops)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_attn = 0
        per_block = 0
        counts = {"attn": 0, "local_attn": 0, "rglru": 0, "mlstm": 0,
                  "slstm": 0}
        for i in range(self.n_layers):
            counts[self.pattern_for_layer(i)] += 1
        attn_params = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.n_experts:
            ff = self.n_experts * d * self.d_ff * (
                3 if self.mlp_variant in ("swiglu", "geglu") else 2) \
                + d * self.n_experts
        else:
            ff = d * self.d_ff * (
                3 if self.mlp_variant in ("swiglu", "geglu") else 2)
        d_rnn = self.d_rnn or d
        rglru_params = d * d_rnn * 2 + d_rnn * d_rnn * 2 + d_rnn * d + d_rnn
        mlstm_params = d * hd * self.n_heads * 4 + d * self.n_heads * 2 + \
            self.n_heads * hd * d
        slstm_params = d * d_rnn * 4 + d_rnn * d
        total = (counts["attn"] + counts["local_attn"]) * (attn_params + ff) \
            + counts["rglru"] * (rglru_params + ff) \
            + counts["mlstm"] * mlstm_params \
            + counts["slstm"] * slstm_params
        total += self.vocab * d  # embeddings (tied head)
        if self.is_encoder_decoder:
            total += self.n_enc_layers * (attn_params + ff) \
                + self.n_layers * attn_params  # cross attention
        total += self.n_layers * d * 2  # norms
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k of n_experts), for the
        6*N_active*D MODEL_FLOPS roofline term."""
        total = self.param_count()
        if not self.n_experts:
            return total
        ff_one = self.d_model * self.d_ff * (
            3 if self.mlp_variant in ("swiglu", "geglu") else 2)
        n_moe = sum(1 for i in range(self.n_layers)
                    if self.pattern_for_layer(i) in ("attn", "local_attn"))
        inactive = n_moe * ff_one * (self.n_experts - self.moe_top_k)
        return int(total - inactive)


_REGISTRY: Dict[str, str] = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "huscf-gan": "repro_torch.configs.huscf_gan",
}


def list_archs():
    return sorted(k for k in _REGISTRY if k != "huscf-gan")


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(_REGISTRY[name])
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(_REGISTRY[name])
    return mod.smoke()


# ---------------------------------------------------------------------------
# input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
