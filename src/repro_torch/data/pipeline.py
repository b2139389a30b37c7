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

With a mesh (``stage_clients(..., mesh=)``) every rank stages every
group's rows, as the reference replicates the trainer's state on its
mesh: every rank runs the whole training step, and only the federation
round shards the client rows. (The reference also shards the dataset's
rows over the mesh's client axes; keeping only a rank's rows comes with
the client-sharded training step.)
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Sequence, Tuple

import torch

from repro_torch.data.partition import ClientSpec, padded_stack
from repro_torch.launch.mesh import check_mesh

if TYPE_CHECKING:
    from repro_torch.core.splitting import ProfileGroup


@dataclasses.dataclass
class DeviceDataset:
    """Per-group padded client rows, staged on the device once."""
    order: Tuple[str, ...]
    images: Dict[str, torch.Tensor]     # gname -> [K_p, n_max, H, W, C]
    labels: Dict[str, torch.Tensor]     # gname -> [K_p, n_max] (-1 pad)
    counts: Dict[str, torch.Tensor]     # gname -> [K_p]

    @property
    def n_clients(self) -> int:
        return sum(int(c.shape[0]) for c in self.counts.values())


def stage_clients(groups: Sequence["ProfileGroup"],
                  clients: Sequence[ClientSpec],
                  device, mesh: Any = None) -> DeviceDataset:
    """Pad + upload every group's client datasets (on a ``mesh``, every
    rank all of them)."""
    check_mesh(mesh)
    images, labels, counts = {}, {}, {}
    for g in groups:
        imgs, labs, cnt = padded_stack([clients[cid] for cid in g.client_ids])
        if (cnt <= 0).any():
            empty = [int(c) for c, n in zip(g.client_ids, cnt) if n <= 0]
            raise ValueError(f"clients {empty} in group {g.name} have no "
                             "samples — cannot stage an empty dataset")
        images[g.name] = torch.as_tensor(imgs, device=device)
        labels[g.name] = torch.as_tensor(labs, device=device)
        counts[g.name] = torch.as_tensor(cnt, device=device)
    return DeviceDataset(tuple(g.name for g in groups), images, labels,
                         counts)


def sample_batch(ds: DeviceDataset, gen: torch.Generator, *, batch: int,
                 z_dim: int, num_classes: int
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Draw one training batch on the device: per-client real rows at
    indices in [0, counts[k]), latent ``z`` and fake labels, all from
    ``gen`` in the staged group order."""
    out: Dict[str, Dict[str, torch.Tensor]] = {
        "real_img": {}, "real_y": {}, "z": {}, "fake_y": {}}
    for name in ds.order:
        counts = ds.counts[name]
        k_cl = counts.shape[0]
        dev = counts.device
        u = torch.rand((k_cl, batch), generator=gen, device=dev)
        idx = torch.minimum((u * counts[:, None]).long(),
                            (counts[:, None] - 1).long())
        rows = torch.arange(k_cl, device=dev)[:, None]
        out["real_img"][name] = ds.images[name][rows, idx]
        out["real_y"][name] = ds.labels[name][rows, idx]
        out["z"][name] = torch.randn((k_cl, batch, z_dim), generator=gen,
                                     device=dev)
        out["fake_y"][name] = torch.randint(0, num_classes, (k_cl, batch),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)
    return out
