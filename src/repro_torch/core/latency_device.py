"""Port of ``repro.core.latency_jax``: the analytic latency model,
Eq. (3)-(10), on the device and batched over whole GA populations.

The host model (``core.latency.huscf_iteration_latency``) walks Python
loops over clients x layers per evaluation. This module evaluates a
``[P, K]`` population of per-client cut-option indices at once:

* everything that depends only on (client, cut option) is computed on
  the host in float64 (head/tail compute, Eq. 3/4, from segment-FLOP
  prefix sums; up/downlink transmission, Eq. 5/6, from the cut layer's
  ``act_bytes``), rounded once to float32 and staged as ``[K, O]``
  tables (O = 16 cut options at n = 5), so an evaluation is gathers;
* the Eq. 7/8 cumulative server schedules are the recurrence
  ``S[i+1] = max(S[i] + srv[i] * n_active[i], barrier[i])`` over the
  static n = 5 layer axis (``segments.join_barrier_scan``), with each
  layer's client-join barrier a masked max over the K clients;
* the population axis is a leading broadcast axis of every tensor.

The float32 operations run in the reference's order (``srv * n_act``
before the add, ``(S[t] + down) + tail``, ``gf + gb + 3 * (df + db)``),
so a population scores bit for bit as the reference scores it and a GA
fed the same draws takes the same path. The result tracks the host
float64 model to ~1e-7 relative.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.latency import (Cut, DeviceProfile, PAPER_SERVER,
                                      all_cut_options)
from repro_torch.core.segments import join_barrier_scan
from repro_torch.models.gan import DISC_LAYER_COSTS, GEN_LAYER_COSTS


class NetTables(NamedTuple):
    """Per-network static tensors for one device population.

    [K, O]: per-(client, option) latency terms (seconds, float32).
    [O]:    per-option server downlink terms and cut indices.
    [n]:    per-layer server compute (per participating client).
    """
    head_f: torch.Tensor         # [K, O] Eq. 3 head forward
    head_b: torch.Tensor         # [K, O] Eq. 4 head backward
    tail_f: torch.Tensor         # [K, O]
    tail_b: torch.Tensor         # [K, O]
    up_f: torch.Tensor           # [K, O] Eq. 5 uplink at the head cut
    up_b: torch.Tensor           # [K, O] Eq. 5 uplink at the tail cut (bwd)
    down_f: torch.Tensor         # [O]    Eq. 6 server downlink (fwd)
    down_b: torch.Tensor         # [O]
    srv_f: torch.Tensor          # [n]    server per-layer fwd compute
    srv_b: torch.Tensor          # [n]
    cut_h: torch.Tensor          # [O] int64 head end layer
    cut_t: torch.Tensor          # [O] int64 tail start layer


class LatencyTables(NamedTuple):
    gen: NetTables
    disc: NetTables


def _net_tables(costs, pairs, devices: Sequence[DeviceProfile],
                server: DeviceProfile, batch: int, device) -> NetTables:
    """Host float64 table build for one network (G or D), rounded once
    to float32 on ``device``."""
    n = len(costs)
    b = float(batch)
    ff = np.concatenate([[0.0], np.cumsum([c.flops_fwd for c in costs])])
    fb = np.concatenate([[0.0], np.cumsum([c.flops_bwd for c in costs])])
    act = np.array([c.act_bytes for c in costs], np.float64)
    h = np.array([p[0] for p in pairs], np.int64)      # [O]
    t = np.array([p[1] for p in pairs], np.int64)
    flops_dev = np.array([d.flops_per_s for d in devices], np.float64)
    rate_dev = np.array([d.rate_bytes_per_s for d in devices], np.float64)

    head_flops_f = ff[h]                               # [O]
    head_flops_b = fb[h]
    tail_flops_f = ff[n] - ff[t]
    tail_flops_b = fb[n] - fb[t]

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64).astype(np.float32),
                               device=device)

    return NetTables(
        head_f=f32(b * head_flops_f[None, :] / flops_dev[:, None]),
        head_b=f32(b * head_flops_b[None, :] / flops_dev[:, None]),
        tail_f=f32(b * tail_flops_f[None, :] / flops_dev[:, None]),
        tail_b=f32(b * tail_flops_b[None, :] / flops_dev[:, None]),
        up_f=f32(b * act[h - 1][None, :] / rate_dev[:, None]),
        up_b=f32(b * act[t - 1][None, :] / rate_dev[:, None]),
        down_f=f32(b * act[t - 1] / server.rate_bytes_per_s),
        down_b=f32(b * act[h - 1] / server.rate_bytes_per_s),
        srv_f=f32(b * np.array([c.flops_fwd for c in costs])
                  / server.flops_per_s),
        srv_b=f32(b * np.array([c.flops_bwd for c in costs])
                  / server.flops_per_s),
        cut_h=torch.as_tensor(h, device=device),
        cut_t=torch.as_tensor(t, device=device),
    )


def build_latency_tables(devices: Sequence[DeviceProfile],
                         server: DeviceProfile = PAPER_SERVER,
                         batch: int = 64,
                         options: Optional[List[Cut]] = None,
                         device="cuda") -> LatencyTables:
    """Stage the per-population static tensors on ``device``.
    ``options`` must be the list the caller indexes into (default
    ``all_cut_options()``); G and D tables share that option axis."""
    options = all_cut_options() if options is None else options
    g_pairs = [(c.g_h, c.g_t) for c in options]
    d_pairs = [(c.d_h, c.d_t) for c in options]
    return LatencyTables(
        gen=_net_tables(GEN_LAYER_COSTS, g_pairs, devices, server, batch,
                        device),
        disc=_net_tables(DISC_LAYER_COSTS, d_pairs, devices, server, batch,
                         device))


def _one_net_latency(t: NetTables, idx: torch.Tensor,
                     counts: Optional[torch.Tensor] = None):
    """(L_f, L_b), each ``[P]``, for one network and a population
    ``idx [P, K]`` of cut-option indices; mirrors
    ``latency._one_net_latency``.

    ``counts[k]`` (optional, float32) says row k of the tables stands
    for that many identical clients (appendix D profile collapse): the
    Eq. 7/8 ``n_active`` terms weight by it, while the barrier and
    completion maxes are unchanged because identical clients contribute
    identical join terms."""
    idx = idx.long()
    rows = torch.arange(idx.shape[1], device=idx.device)
    h = t.cut_h[idx]                          # [P, K]
    tt = t.cut_t[idx]
    head_f = t.head_f[rows, idx]
    head_b = t.head_b[rows, idx]
    tail_f = t.tail_f[rows, idx]
    tail_b = t.tail_b[rows, idx]
    up_f = t.up_f[rows, idx]
    up_b = t.up_b[rows, idx]
    down_f = t.down_f[idx]
    down_b = t.down_b[idx]

    n = t.srv_f.shape[0]
    li = torch.arange(n, device=idx.device)[None, :, None]       # [1, n, 1]
    hh, ttt = h[:, None, :], tt[:, None, :]                      # [P, 1, K]
    # [P, n, K] layer-participation mask: h[k] <= i < t[k]
    active = (hh <= li) & (li < ttt)
    if counts is None:
        n_act = active.sum(-1).to(torch.float32)
    else:
        n_act = (active * counts).sum(-1)
    # per-layer join barriers as masked maxes over the clients (join
    # terms are >= 0, so an empty layer's max with 0 matches the host
    # model's "max(joins) if joins else 0.0")
    zero = torch.zeros((), dtype=torch.float32, device=idx.device)
    barr_f = torch.where(hh == li, (head_f + up_f)[:, None, :],
                         zero).amax(-1)
    barr_b = torch.where(ttt == li + 1, (tail_b + up_b)[:, None, :],
                         zero).amax(-1)

    # Eq. 7: S_f[i+1] = max(S_f[i] + srv_f[i] * n_active[i], barrier[i])
    s_f = join_barrier_scan(t.srv_f * n_act, barr_f)
    s_f = torch.cat([torch.zeros_like(s_f[:, :1]), s_f], 1)     # [P, n+1]
    l_f = (s_f.gather(1, tt) + down_f + tail_f).amax(1)
    # Eq. 8: S_b[i] = max(S_b[i+1] + srv_b[i] * n_active[i], barrier[i]),
    # swept top layer down (values stay in layer order)
    s_b = join_barrier_scan(t.srv_b * n_act, barr_b, reverse=True)
    s_b = torch.cat([s_b, torch.zeros_like(s_b[:, :1])], 1)     # [P, n+1]
    l_b = (s_b.gather(1, h) + down_b + head_b).amax(1)
    return l_f, l_b


def population_latency(tables: LatencyTables, idx_pop: torch.Tensor,
                       counts: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Eq. (10) over a population: ``idx_pop [P, K]`` cut-option indices
    (positions into the ``options`` the tables were built from) ->
    ``[P]`` float32 iteration latencies."""
    gf, gb = _one_net_latency(tables.gen, idx_pop, counts)
    df, db = _one_net_latency(tables.disc, idx_pop, counts)
    return gf + gb + 3.0 * (df + db)


def huscf_iteration_latency_dev(tables: LatencyTables, idx: torch.Tensor,
                                counts: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Eq. (10) for one individual: ``idx [K]`` -> scalar float32."""
    return population_latency(tables, idx[None], counts)[0]
