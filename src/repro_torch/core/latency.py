"""Analytic latency model — paper §4.2, Eq. (3)-(10), on the host in
float64 (port of ``repro.core.latency``, the parts the trainer uses).

Indexing convention (half-open segments over n layers):
    head  = layers [0, l_H)      l_H >= 1
    server= layers [l_H, l_T)    must contain the middle layer
    tail  = layers [l_T, n)      l_T <= n - 1
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.models.gan import DISC_LAYER_COSTS, GEN_LAYER_COSTS, LayerCost


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Paper Table 4 row."""
    name: str
    freq_hz: float
    flops_per_cycle: float
    rate_bytes_per_s: float

    @property
    def flops_per_s(self) -> float:
        return self.freq_hz * self.flops_per_cycle


# Paper Table 4 (frequencies in MHz there).
PAPER_DEVICES: Tuple[DeviceProfile, ...] = (
    DeviceProfile("device1", 480e6, 1, 50e6),
    DeviceProfile("device2", 6000e6, 8, 150e6),
    DeviceProfile("device3", 15600e6, 8, 1000e6),
    DeviceProfile("device4", 5720e6, 8, 300e6),
    DeviceProfile("device5", 4000e6, 4, 50e6),
    DeviceProfile("device6", 9000e6, 4, 100e6),
    DeviceProfile("device7", 12000e6, 10, 800e6),
)
PAPER_SERVER = DeviceProfile("server", 42000e6, 16, 1000e6)


@dataclasses.dataclass(frozen=True)
class Cut:
    """Four cut points for one client: (G head end, G tail start, D head
    end, D tail start)."""
    g_h: int
    g_t: int
    d_h: int
    d_t: int

    def as_tuple(self) -> Tuple[int, int, int, int]:
        return (self.g_h, self.g_t, self.d_h, self.d_t)


def valid_cuts(n_layers: int) -> List[Tuple[int, int]]:
    """All (l_H, l_T) with >=1 head layer, >=1 tail layer, middle on
    the server."""
    mid = n_layers // 2
    return [(h, t) for h in range(1, mid + 1)
            for t in range(mid + 1, n_layers)]


def all_cut_options(n_g: int = 5, n_d: int = 5) -> List[Cut]:
    return [Cut(gh, gt, dh, dt)
            for gh, gt in valid_cuts(n_g)
            for dh, dt in valid_cuts(n_d)]


def _segment_flops(costs: Sequence[LayerCost], start: int, stop: int,
                   backward: bool) -> float:
    if backward:
        return sum(c.flops_bwd for c in costs[start:stop])
    return sum(c.flops_fwd for c in costs[start:stop])


def _one_net_latency(costs: Sequence[LayerCost],
                     cuts: Sequence[Tuple[int, int]],
                     devices: Sequence[DeviceProfile],
                     server: DeviceProfile, batch: int,
                     ) -> Tuple[float, float]:
    """Forward & backward latency (Eq. 7-9) for one network (G or D)."""
    n = len(costs)
    b = float(batch)
    K = len(cuts)

    head_f = [b * _segment_flops(costs, 0, cuts[k][0], False) / devices[k].flops_per_s
              for k in range(K)]
    head_b = [b * _segment_flops(costs, 0, cuts[k][0], True) / devices[k].flops_per_s
              for k in range(K)]
    tail_f = [b * _segment_flops(costs, cuts[k][1], n, False) / devices[k].flops_per_s
              for k in range(K)]
    tail_b = [b * _segment_flops(costs, cuts[k][1], n, True) / devices[k].flops_per_s
              for k in range(K)]
    # uplink: bytes of head's final activation (fwd) / tail-input gradient (bwd)
    up_f = [b * costs[cuts[k][0] - 1].act_bytes / devices[k].rate_bytes_per_s
            for k in range(K)]
    up_b = [b * costs[cuts[k][1] - 1].act_bytes / devices[k].rate_bytes_per_s
            for k in range(K)]
    # downlink from server
    down_f = [b * costs[cuts[k][1] - 1].act_bytes / server.rate_bytes_per_s
              for k in range(K)]
    down_b = [b * costs[cuts[k][0] - 1].act_bytes / server.rate_bytes_per_s
              for k in range(K)]

    # server per-layer compute (per participating client)
    srv_f = [b * costs[i].flops_fwd / server.flops_per_s for i in range(n)]
    srv_b = [b * costs[i].flops_bwd / server.flops_per_s for i in range(n)]
    n_active = [sum(1 for k in range(K) if cuts[k][0] <= i < cuts[k][1])
                for i in range(n)]

    # Eq. 7 forward cumulative schedule over server layers
    S_f = [0.0] * (n + 1)
    for i in range(n):
        joins = [head_f[k] + up_f[k] for k in range(K) if cuts[k][0] == i]
        barrier = max(joins) if joins else 0.0
        S_f[i + 1] = max(S_f[i] + srv_f[i] * n_active[i], barrier)

    # Eq. 9 forward total: slowest client finishing its tail
    L_f = max(S_f[cuts[k][1]] + down_f[k] + tail_f[k] for k in range(K))

    # Eq. 8 backward cumulative schedule (from top layer down)
    S_b = [0.0] * (n + 2)
    for i in range(n - 1, -1, -1):
        joins = [tail_b[k] + up_b[k] for k in range(K) if cuts[k][1] == i + 1]
        barrier = max(joins) if joins else 0.0
        S_b[i] = max(S_b[i + 1] + srv_b[i] * n_active[i], barrier)

    L_b = max(S_b[cuts[k][0]] + down_b[k] + head_b[k] for k in range(K))
    return L_f, L_b


def huscf_iteration_latency(cuts: Sequence[Cut],
                            devices: Sequence[DeviceProfile],
                            server: DeviceProfile = PAPER_SERVER,
                            batch: int = 64) -> float:
    """Eq. (10): L_T = L_G^F + L_G^B + 3 (L_D^F + L_D^B)."""
    g_cuts = [(c.g_h, c.g_t) for c in cuts]
    d_cuts = [(c.d_h, c.d_t) for c in cuts]
    gf, gb = _one_net_latency(GEN_LAYER_COSTS, g_cuts, devices, server, batch)
    df, db = _one_net_latency(DISC_LAYER_COSTS, d_cuts, devices, server, batch)
    return gf + gb + 3.0 * (df + db)
