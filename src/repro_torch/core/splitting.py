"""Cut/segment machinery for layered models — paper §4.1/§4.4 (port of
``repro.core.splitting``).

Clients sharing a device profile and a cut form a ``ProfileGroup``;
their client-side segments stack on a leading client axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.latency import Cut, DeviceProfile


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


def client_owned_layers(cut_pair: Tuple[int, int], n_layers: int) -> List[int]:
    return list(range(0, cut_pair[0])) + list(range(cut_pair[1], n_layers))


def server_union_span(groups: Sequence[ProfileGroup], net: str,
                      n_layers: int) -> List[int]:
    """All layer indices any client delegates to the server for net G|D."""
    owned = set()
    for g in groups:
        h, t = layer_pair(g.cut, net)
        owned |= set(range(h, t))
    return sorted(owned)


def layer_pair(cut: Cut, net: str) -> Tuple[int, int]:
    return (cut.g_h, cut.g_t) if net == "G" else (cut.d_h, cut.d_t)
