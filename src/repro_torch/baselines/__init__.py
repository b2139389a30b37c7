"""The five baseline distributed-GAN schemes of paper §6 (port of
``repro.baselines``), under the reference's names."""
from repro_torch.baselines.common import BaselineConfig, PopulationTrainer
from repro_torch.baselines.fedgan import FedGANTrainer
from repro_torch.baselines.mdgan import MDGANTrainer
from repro_torch.baselines.fed_split_gan import FedSplitGANTrainer
from repro_torch.baselines.pfl_gan import PFLGANTrainer
from repro_torch.baselines.hfl_gan import HFLGANTrainer

ALL_BASELINES = {
    "fedgan": FedGANTrainer,
    "mdgan": MDGANTrainer,
    "fed_split_gan": FedSplitGANTrainer,
    "pfl_gan": PFLGANTrainer,
    "hfl_gan": HFLGANTrainer,
}
