"""Device-resident data pipeline for the split-learning trainer (port of
``repro.data.pipeline``).

``DeviceDataset`` stages every profile group's client datasets on the
device once — padded per-client rows plus valid counts — and
``sample_batch`` draws each training batch there from a
``torch.Generator`` on the same device, so epochs never touch host
numpy.

Layout per group (clients in the group's canonical order):
  * images [K_p, n_max, H, W, C] f32 — rows zero-padded past each
    client's ``n``
  * labels [K_p, n_max] int32 — padding holds ``-1``
  * counts [K_p] int32 — indices are drawn in [0, counts[k]), so
    padding rows are never read

With a mesh (``stage_clients(..., mesh=)``) whose data axes divide
every group's size (``step_client_axes``, the rule of the client-sharded
training step), rank r of n keeps only block r of every group's rows
(``sharding.policy.row_block``) of ``images`` and ``labels``, as the
reference shards the dataset's client axis
(``client_stack_sharding``); ``counts`` keep every row, and
``blocks`` says which rows the rank holds. ``sample_batch`` draws the
whole group's indices, latents and fake labels from the generator, as
an unsharded dataset does, and slices the rank's block before the
gather: every rank's batch is its rows of the unsharded batch. When a
group does not divide, every rank stages every row (the reference's
``sanitize`` replicates what it cannot split) and runs the whole step.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.partition import ClientSpec, padded_stack
from repro_torch.launch.mesh import check_mesh, in_mesh
from repro_torch.sharding.policy import group_client_axes, row_block

if TYPE_CHECKING:
    from repro_torch.core.splitting import ProfileGroup


@dataclasses.dataclass
class DeviceDataset:
    """Per-group padded client rows, staged on the device once."""
    order: Tuple[str, ...]
    images: Dict[str, torch.Tensor]     # gname -> [K_p, n_max, H, W, C]
    labels: Dict[str, torch.Tensor]     # gname -> [K_p, n_max] (-1 pad)
    counts: Dict[str, torch.Tensor]     # gname -> [K_p]
    # gname -> [lo, hi) of the group's rows staged on this rank (a
    # client-sharded step's block; all of them otherwise)
    blocks: Dict[str, Tuple[int, int]]

    @property
    def n_clients(self) -> int:
        return sum(int(c.shape[0]) for c in self.counts.values())


def step_client_axes(groups: Sequence["ProfileGroup"], mesh: Any):
    """The mesh axes over which a client-sharded training step shards
    every group's rows, or None (every rank holds and runs every row): a
    mesh of more than one rank, on which this rank holds a coordinate,
    whose data axes divide every group's size
    (``policy.group_client_axes``)."""
    if mesh is None or mesh.size() == 1 or not in_mesh(mesh):
        return None
    return group_client_axes(mesh, [g.size for g in groups])


def stage_clients(groups: Sequence["ProfileGroup"],
                  clients: Sequence[ClientSpec],
                  device, mesh: Any = None) -> DeviceDataset:
    """Pad + upload every group's client datasets: on a ``mesh`` that
    shards the step (``step_client_axes``) only this rank's block of
    each group's rows, and every row's count."""
    check_mesh(mesh)
    axes = step_client_axes(groups, mesh)
    images, labels, counts, blocks = {}, {}, {}, {}
    for g in groups:
        cnt = np.array([clients[cid].n for cid in g.client_ids], np.int32)
        if (cnt <= 0).any():
            empty = [int(c) for c, n in zip(g.client_ids, cnt) if n <= 0]
            raise ValueError(f"clients {empty} in group {g.name} have no "
                             "samples — cannot stage an empty dataset")
        lo, hi = blocks[g.name] = row_block(mesh, g.size, axes)
        imgs, labs, _ = padded_stack([clients[cid]
                                      for cid in g.client_ids[lo:hi]])
        images[g.name] = torch.as_tensor(imgs, device=device)
        labels[g.name] = torch.as_tensor(labs, device=device)
        counts[g.name] = torch.as_tensor(cnt, device=device)
    return DeviceDataset(tuple(g.name for g in groups), images, labels,
                         counts, blocks)


def sample_batch(ds: DeviceDataset, gen: torch.Generator, *, batch: int,
                 z_dim: int, num_classes: int
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Draw one training batch on the device: per-client real rows at
    indices in [0, counts[k]), latent ``z`` and fake labels, all from
    ``gen`` in the staged group order. Every group's draws cover all of
    its rows; a dataset that holds a block of them (``ds.blocks``)
    returns the block's rows of the batch."""
    out: Dict[str, Dict[str, torch.Tensor]] = {
        "real_img": {}, "real_y": {}, "z": {}, "fake_y": {}}
    for name in ds.order:
        counts = ds.counts[name]
        k_cl = counts.shape[0]
        lo, hi = ds.blocks[name]
        dev = counts.device
        u = torch.rand((k_cl, batch), generator=gen, device=dev)
        idx = torch.minimum((u * counts[:, None]).long(),
                            (counts[:, None] - 1).long())[lo:hi]
        rows = torch.arange(hi - lo, device=dev)[:, None]
        out["real_img"][name] = ds.images[name][rows, idx]
        out["real_y"][name] = ds.labels[name][rows, idx]
        out["z"][name] = torch.randn((k_cl, batch, z_dim), generator=gen,
                                     device=dev)[lo:hi]
        out["fake_y"][name] = torch.randint(0, num_classes, (k_cl, batch),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)[lo:hi]
    return out
