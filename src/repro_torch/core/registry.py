"""Client population registry and per-round cohort sampling (port of
``repro.core.registry``).

The server knows every registered client (id, dataset size); each
federation round samples a cohort of S of the N registered clients,
aggregates over the cohort and leaves everyone else as they were.
Global client ids are the positions 0..N-1, as in
``ProfileGroup.client_ids``.

Cohorts are drawn from a ``torch.Generator`` on its own device (a sorted
``randperm`` prefix, so ids are unique). JAX's PRNG cannot be
reproduced, so a cohort differs from the reference's for the same seed;
the tests feed the reference's draws in instead.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ClientRegistry:
    """The server's view of the registered population: ``sizes[k]`` is
    client k's dataset size (the ``n_k`` of Eq. 15)."""
    sizes: np.ndarray                    # [N] int64 dataset sizes

    def __post_init__(self):
        object.__setattr__(self, "sizes",
                           np.asarray(self.sizes, np.int64).reshape(-1))

    @classmethod
    def from_clients(cls, clients: Sequence) -> "ClientRegistry":
        """From ``data.partition.ClientSpec``-likes (anything with
        ``.n``)."""
        return cls(np.array([c.n for c in clients], np.int64))

    @property
    def n_clients(self) -> int:
        return int(self.sizes.shape[0])

    def sample_cohort(self, gen: torch.Generator, cohort_size: int
                      ) -> torch.Tensor:
        """Sorted unique client ids ``[cohort_size]`` int32, drawn without
        replacement from ``gen`` on the generator's device."""
        n = self.n_clients
        s = int(cohort_size)
        if not 1 <= s <= n:
            raise ValueError(
                f"cohort_size {s} out of range for a registry of {n}")
        perm = torch.randperm(n, generator=gen, device=gen.device)
        return torch.sort(perm[:s]).values.to(torch.int32)

    def cohort_mask(self, cohort_ids: torch.Tensor) -> torch.Tensor:
        """[N] bool participation mask from sampled ids, on their
        device."""
        mask = torch.zeros(self.n_clients, dtype=torch.bool,
                           device=cohort_ids.device)
        mask[cohort_ids.long()] = True
        return mask

    def churn(self, leave: Sequence[int] = (),
              join_sizes: Sequence[int] = ()
              ) -> Tuple["ClientRegistry", List[int]]:
        """Membership churn: ``leave`` = registered ids exiting,
        ``join_sizes`` = dataset sizes of new registrants. Returns the
        post-churn registry and ``old_of`` (new global id -> old id, -1
        for joiners): survivors compact down in registration order,
        joiners append."""
        leave_set = {int(c) for c in leave}
        bad = sorted(c for c in leave_set if not 0 <= c < self.n_clients)
        if bad:
            raise ValueError(f"unknown client ids in leave: {bad}")
        old_of = [c for c in range(self.n_clients) if c not in leave_set]
        sizes = [int(self.sizes[o]) for o in old_of]
        for s in join_sizes:
            old_of.append(-1)
            sizes.append(int(s))
        if not sizes:
            raise ValueError("churn would leave an empty registry")
        return ClientRegistry(np.array(sizes, np.int64)), old_of
