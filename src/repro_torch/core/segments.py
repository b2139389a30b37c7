"""SplitProgram — one compiled representation of a cut configuration
(port of ``repro.core.segments``: the program table, the executor that
training and serving run, and the analytic latency of the same program).

A cut configuration compiles once into per-group client heads, a
sequence of server steps with explicit join/depart barriers, and
per-group client tails. ``make_apply`` executes it:

* heads and tails run each profile group's stacked clients as one call
  with per-client weights, so their BatchNorm statistics are per
  client;
* each server step concatenates the rows of every active group, in
  group order, so server BatchNorm statistics span the population;
* the captured middle is each client's batch mean of the middle
  layer's output, flattened in H, W, C order.

With ``train=False`` every BatchNorm uses its running statistics, so
each output row depends on its own input row alone: the serving
engine's bucket-padding rows cannot touch valid rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.latency import PAPER_SERVER, DeviceProfile
from repro_torch.core.splitting import (ProfileGroup, bucket_size, layer_pair,
                                        server_union_span)
from repro_torch.models.gan import NET_LAYER_COSTS, NET_LAYER_DEFS
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    """One typed client-side layer range of the program."""
    kind: str                    # "head" | "tail"
    gname: str
    start: int                   # half-open layer range [start, stop)
    stop: int


@dataclasses.dataclass(frozen=True)
class ServerStep:
    """One server layer: ``active`` groups concatenate in this order,
    ``joins`` are groups whose head ends here, ``departs`` groups whose
    server span ends after this layer."""
    layer: int
    active: Tuple[str, ...]
    joins: Tuple[str, ...]
    departs: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SplitProgram:
    """Compiled cut configuration for one network (G or D)."""
    net: str
    n_layers: int
    middle: int
    group_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    buckets: Tuple[int, ...]
    cuts: Tuple[Tuple[int, int], ...]
    heads: Tuple[Segment, ...]
    steps: Tuple[ServerStep, ...]
    tails: Tuple[Segment, ...]

    def index_of(self, gname: str) -> int:
        return self.group_names.index(gname)

    def size_of(self, gname: str) -> int:
        return self.sizes[self.index_of(gname)]

    def server_span(self) -> Tuple[int, ...]:
        return tuple(s.layer for s in self.steps)


def compile_split_program(groups: Sequence[ProfileGroup], net: str,
                          n_layers: Optional[int] = None) -> SplitProgram:
    if n_layers is None:
        n_layers = len(NET_LAYER_DEFS[net])
    names = tuple(g.name for g in groups)
    cuts = tuple(layer_pair(g.cut, net) for g in groups)
    sizes = tuple(g.size for g in groups)
    steps = []
    for l in server_union_span(groups, net, n_layers):
        active = tuple(n for n, (h, t) in zip(names, cuts) if h <= l < t)
        joins = tuple(n for n, (h, _) in zip(names, cuts) if h == l)
        departs = tuple(n for n, (_, t) in zip(names, cuts) if t == l + 1)
        steps.append(ServerStep(l, active, joins, departs))
    return SplitProgram(
        net=net, n_layers=n_layers, middle=n_layers // 2,
        group_names=names, sizes=sizes,
        buckets=tuple(bucket_size(s) for s in sizes), cuts=cuts,
        heads=tuple(Segment("head", n, 0, h)
                    for n, (h, _) in zip(names, cuts)),
        steps=tuple(steps),
        tails=tuple(Segment("tail", n, t, n_layers)
                    for n, (_, t) in zip(names, cuts)))


def _client_pass(defs, params, x, start: int, stop: int, train: bool):
    new = {}
    for l in range(start, stop):
        x, new[str(l)] = defs[l].apply(params[str(l)], x, train)
    return x, new


def _server_layer(layer_def, params, x, train: bool):
    """A shared server layer on concatenated rows [N, ...]: run it as a
    single copy (K = 1) of the client-batched layer."""
    y, upd = layer_def.apply(tree_map(lambda t: t[None], params), x[None],
                             train)
    return y[0], tree_map(lambda t: t[0], upd)


def make_apply(program: SplitProgram, capture_middle: bool = False
               ) -> Callable:
    """Returns ``apply(client_params, server_params, inputs, train) ->
    (outputs {gname: [K, b, ...]}, new_client, new_server, middles)``
    with ``inputs`` = {gname: tuple of per-client-stacked tensors fed
    to layer 0}."""
    defs = NET_LAYER_DEFS[program.net]
    n = program.n_layers
    middle = program.middle

    def apply(client_params, server_params, inputs, train: bool):
        new_client = {name: dict(client_params[name])
                      for name in program.group_names}
        new_server = dict(server_params)
        bufs: Dict[str, torch.Tensor] = {}
        shapes: Dict[str, Tuple[int, int]] = {}
        for seg in program.heads:
            acts, upd = _client_pass(defs, client_params[seg.gname],
                                     inputs[seg.gname], 0, seg.stop, train)
            new_client[seg.gname].update(upd)
            k, b = acts.shape[0], acts.shape[1]
            shapes[seg.gname] = (k, b)
            bufs[seg.gname] = acts.reshape((k * b,) + acts.shape[2:])
        outs: Dict[str, torch.Tensor] = {}
        middles: Dict[str, torch.Tensor] = {}
        for step in program.steps:
            l = step.layer
            xs = [bufs[gname] for gname in step.active]
            sizes = [x.shape[0] for x in xs]
            x = torch.cat(xs, 0) if len(xs) > 1 else xs[0]
            x, new_server[str(l)] = _server_layer(
                defs[l], server_params[str(l)], x, train)
            parts = torch.split(x, sizes, 0) if len(xs) > 1 else [x]
            for gname, part in zip(step.active, parts):
                bufs[gname] = part
                if capture_middle and l == middle:
                    k, b = shapes[gname]
                    middles[gname] = part.reshape(k, b, -1).float().mean(1)
                if gname in step.departs:
                    outs[gname] = part
        results: Dict[str, torch.Tensor] = {}
        for seg in program.tails:
            k, b = shapes[seg.gname]
            x = outs[seg.gname]
            x = x.reshape((k, b) + x.shape[1:])
            y, upd = _client_pass(defs, client_params[seg.gname], x,
                                  seg.start, n, train)
            new_client[seg.gname].update(upd)
            results[seg.gname] = y
        return results, new_client, new_server, middles

    return apply


# ---------------------------------------------------------------------------
# analytic latency evaluated from the program structure (host float64)
# ---------------------------------------------------------------------------

def _seg_flops(costs, start: int, stop: int, backward: bool) -> float:
    key = "flops_bwd" if backward else "flops_fwd"
    return sum(getattr(c, key) for c in costs[start:stop])


def program_net_latency(program: SplitProgram,
                        profiles: Mapping[str, DeviceProfile],
                        server: DeviceProfile = PAPER_SERVER,
                        batch: int = 64,
                        counts: Optional[Mapping[str, float]] = None
                        ) -> Tuple[float, float]:
    """(L_f, L_b), Eq. 7-9 for one network from the program structure.
    ``profiles`` maps group name -> DeviceProfile; ``counts`` overrides
    the per-group multiplicities (a serving cohort's requests per cut
    instead of the training population)."""
    costs = NET_LAYER_COSTS[program.net]
    n = program.n_layers
    b = float(batch)
    names = program.group_names
    mult = {g: float(program.size_of(g)) if counts is None
            else float(counts[g]) for g in names}

    head_f, head_b, tail_f, tail_b = {}, {}, {}, {}
    up_f, up_b, down_f, down_b = {}, {}, {}, {}
    for g, (h, t) in zip(names, program.cuts):
        dev = profiles[g]
        head_f[g] = b * _seg_flops(costs, 0, h, False) / dev.flops_per_s
        head_b[g] = b * _seg_flops(costs, 0, h, True) / dev.flops_per_s
        tail_f[g] = b * _seg_flops(costs, t, n, False) / dev.flops_per_s
        tail_b[g] = b * _seg_flops(costs, t, n, True) / dev.flops_per_s
        up_f[g] = b * costs[h - 1].act_bytes / dev.rate_bytes_per_s
        up_b[g] = b * costs[t - 1].act_bytes / dev.rate_bytes_per_s
        down_f[g] = b * costs[t - 1].act_bytes / server.rate_bytes_per_s
        down_b[g] = b * costs[h - 1].act_bytes / server.rate_bytes_per_s

    srv_f = [b * costs[i].flops_fwd / server.flops_per_s for i in range(n)]
    srv_b = [b * costs[i].flops_bwd / server.flops_per_s for i in range(n)]
    step_of = {s.layer: s for s in program.steps}

    # Eq. 7 forward schedule: joins gate the layer, occupancy scales it
    S_f = [0.0] * (n + 1)
    for i in range(n):
        step = step_of.get(i)
        joins = ([head_f[g] + up_f[g] for g in step.joins]
                 if step is not None else [])
        n_act = (sum(mult[g] for g in step.active)
                 if step is not None else 0.0)
        barrier = max(joins) if joins else 0.0
        S_f[i + 1] = max(S_f[i] + srv_f[i] * n_act, barrier)
    L_f = max(S_f[t] + down_f[g] + tail_f[g]
              for g, (_, t) in zip(names, program.cuts))

    # Eq. 8 backward schedule, top layer down
    S_b = [0.0] * (n + 2)
    for i in range(n - 1, -1, -1):
        step = step_of.get(i)
        joins = ([tail_b[g] + up_b[g] for g in step.departs]
                 if step is not None else [])
        n_act = (sum(mult[g] for g in step.active)
                 if step is not None else 0.0)
        barrier = max(joins) if joins else 0.0
        S_b[i] = max(S_b[i + 1] + srv_b[i] * n_act, barrier)
    L_b = max(S_b[h] + down_b[g] + head_b[g]
              for g, (h, _) in zip(names, program.cuts))
    return L_f, L_b


def program_forward_latency(program: SplitProgram,
                            profiles: Mapping[str, DeviceProfile],
                            server: DeviceProfile = PAPER_SERVER,
                            batch: int = 64,
                            counts: Optional[Mapping[str, float]] = None
                            ) -> float:
    """Serving prediction: one U-shaped forward pass (Eq. 7 + Eq. 9
    completion, no backward). ``counts`` = requests per cut."""
    l_f, _ = program_net_latency(program, profiles, server, batch,
                                 counts=counts)
    return l_f
