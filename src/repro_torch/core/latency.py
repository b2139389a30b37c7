"""Analytic latency model — paper §4.2, Eq. (3)-(10), on the host in
float64 (port of ``repro.core.latency``: the HuSCF model the trainer
uses and the five baselines' models of paper §6.2).

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


# ---------------------------------------------------------------------------
# baseline latency models (paper §6.2 comparisons)
# ---------------------------------------------------------------------------

def _full_flops(costs: Sequence[LayerCost], backward: bool) -> float:
    return _segment_flops(costs, 0, len(costs), backward)


def fedgan_iteration_latency(devices: Sequence[DeviceProfile],
                             batch: int = 64) -> float:
    """Full G+D on every client; slowest dominates. D trained 3x (Eq. 10 logic)."""
    g = _full_flops(GEN_LAYER_COSTS, False) + _full_flops(GEN_LAYER_COSTS, True)
    d = _full_flops(DISC_LAYER_COSTS, False) + _full_flops(DISC_LAYER_COSTS, True)
    per_sample = g + 3.0 * d
    return max(batch * per_sample / dv.flops_per_s for dv in devices)


def hflgan_iteration_latency(devices: Sequence[DeviceProfile],
                             batch: int = 64) -> float:
    """HFL-GAN trains two generators per client (paper §6.2)."""
    g = _full_flops(GEN_LAYER_COSTS, False) + _full_flops(GEN_LAYER_COSTS, True)
    d = _full_flops(DISC_LAYER_COSTS, False) + _full_flops(DISC_LAYER_COSTS, True)
    per_sample = 2.0 * g + 3.0 * d
    return max(batch * per_sample / dv.flops_per_s for dv in devices)


def pflgan_iteration_latency(devices: Sequence[DeviceProfile],
                             batch: int = 64) -> float:
    """PFL-GAN trains the full cGAN locally (plus server-side refinement
    that is off the client critical path); client-side dominates."""
    return fedgan_iteration_latency(devices, batch) * 1.07  # + local cGAN refresh overhead


def mdgan_iteration_latency(devices: Sequence[DeviceProfile],
                            server: DeviceProfile = PAPER_SERVER,
                            batch: int = 64) -> float:
    """MD-GAN: G on server; clients train D only (3 passes) and receive
    synthetic batches (2 downloads: X_d and X_g per iteration)."""
    d = _full_flops(DISC_LAYER_COSTS, False) + _full_flops(DISC_LAYER_COSTS, True)
    img_bytes = 28 * 28 * 4.0
    K = len(devices)
    g_fwd = batch * _full_flops(GEN_LAYER_COSTS, False) / server.flops_per_s
    # server generates for all clients sequentially, then slowest client D step
    client = max(3.0 * batch * d / dv.flops_per_s
                 + 2.0 * batch * img_bytes / dv.rate_bytes_per_s
                 for dv in devices)
    g_bwd = batch * _full_flops(GEN_LAYER_COSTS, True) / server.flops_per_s * K
    return g_fwd * K + client + g_bwd


def fedsplitgan_iteration_latency(devices: Sequence[DeviceProfile],
                                  server: DeviceProfile = PAPER_SERVER,
                                  batch: int = 64) -> float:
    """Federated Split GANs: G on server, D split per device capability
    (single cut, D-head on client). We model the best single-cut split."""
    n = len(DISC_LAYER_COSTS)
    best = None
    for cut in range(1, n):
        total_client = []
        for dv in devices:
            head_f = batch * _segment_flops(DISC_LAYER_COSTS, 0, cut, False) / dv.flops_per_s
            head_b = batch * _segment_flops(DISC_LAYER_COSTS, 0, cut, True) / dv.flops_per_s
            up = batch * DISC_LAYER_COSTS[cut - 1].act_bytes / dv.rate_bytes_per_s
            total_client.append(3.0 * (head_f + head_b + 2.0 * up))
        srv_d = 3.0 * batch * (_segment_flops(DISC_LAYER_COSTS, cut, n, False)
                               + _segment_flops(DISC_LAYER_COSTS, cut, n, True)) / server.flops_per_s
        srv_g = batch * (_full_flops(GEN_LAYER_COSTS, False)
                         + _full_flops(GEN_LAYER_COSTS, True)) / server.flops_per_s
        # synthetic images shipped to clients
        ship = batch * 28 * 28 * 4.0 / min(dv.rate_bytes_per_s for dv in devices)
        t = max(total_client) + srv_d * len(devices) + srv_g + ship
        best = t if best is None else min(best, t)
    return best
