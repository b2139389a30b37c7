"""FedGAN (Rasouli et al., 2020): vanilla FedAvg over full local cGANs,
weighted by local dataset size (port of ``repro.baselines.fedgan``)."""
from __future__ import annotations

import numpy as np

from repro_torch.baselines.common import PopulationTrainer, fedavg_population


class FedGANTrainer(PopulationTrainer):
    name = "fedgan"

    def federate(self) -> None:
        w = self.sizes.astype(np.float64)
        self.g_params = fedavg_population(self.g_params, w)
        self.d_params = fedavg_population(self.d_params, w)
