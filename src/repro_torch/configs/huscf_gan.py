"""The paper's own architecture: the 3M-param conditional GAN (Table 3),
exposed through the same registry for the launcher."""
import dataclasses
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="huscf-gan", arch_type="gan", n_layers=5, d_model=256,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=10,
    citation="this paper (Table 3)",
    notes="cGAN generator+discriminator; trained via repro.core.huscf.")


def smoke() -> ArchConfig:
    return CONFIG
