"""Cut/segment machinery for layered models — paper §4.1/§4.4 (port of
``repro.core.splitting``).

Clients sharing a device profile and a cut form a ``ProfileGroup``;
their client-side segments stack on a leading client axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core.latency import Cut, DeviceProfile
from repro_torch.tree import tree_map


@dataclasses.dataclass
class ProfileGroup:
    """A set of clients sharing one device profile and one cut."""
    name: str
    profile: DeviceProfile
    cut: Cut
    client_ids: List[int]          # global client indices, canonical order

    @property
    def size(self) -> int:
        return len(self.client_ids)


def group_by_profile(devices: Sequence[DeviceProfile],
                     cuts: Sequence[Cut]) -> List[ProfileGroup]:
    """Group clients whose (profile, cut) coincide. Client order inside a
    group follows global order; groups sorted by name for determinism."""
    table: Dict[Tuple, ProfileGroup] = {}
    for cid, (dev, cut) in enumerate(zip(devices, cuts)):
        key = (dev.name, cut.as_tuple())
        if key not in table:
            table[key] = ProfileGroup(f"{dev.name}|{cut.as_tuple()}", dev,
                                      cut, [])
        table[key].client_ids.append(cid)
    return [table[k] for k in sorted(table.keys(), key=str)]


def bucket_size(n: int) -> int:
    """Round a group/cohort size up to the next power of two (>= 1)."""
    if n < 0:
        raise ValueError(f"bucket_size of negative count {n}")
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def head_layers(cut_pair: Tuple[int, int]) -> range:
    return range(0, cut_pair[0])


def server_layers(cut_pair: Tuple[int, int]) -> range:
    return range(cut_pair[0], cut_pair[1])


def tail_layers(cut_pair: Tuple[int, int], n_layers: int) -> range:
    return range(cut_pair[1], n_layers)


def client_owned_layers(cut_pair: Tuple[int, int], n_layers: int) -> List[int]:
    return list(head_layers(cut_pair)) + list(tail_layers(cut_pair, n_layers))


def server_union_span(groups: Sequence[ProfileGroup], net: str,
                      n_layers: int) -> List[int]:
    """All layer indices any client delegates to the server for net G|D."""
    owned = set()
    for g in groups:
        owned |= set(server_layers(layer_pair(g.cut, net)))
    return sorted(owned)


def stack_params(init_fn: Callable, n: int, gen: torch.Generator, device,
                 dtype=torch.float32):
    """``n`` independent copies of a layer stacked on axis 0:
    ``init_fn(gen, device, dtype)`` draws one copy, and the copies are
    drawn from ``gen`` one after another (the reference vmaps its
    initializer over split keys)."""
    copies = [init_fn(gen, device, dtype) for _ in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *copies)


def layer_pair(cut: Cut, net: str) -> Tuple[int, int]:
    return (cut.g_h, cut.g_t) if net == "G" else (cut.d_h, cut.d_t)
