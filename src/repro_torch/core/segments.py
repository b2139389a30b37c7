"""SplitProgram — one compiled representation of a cut configuration
(port of ``repro.core.segments``: the program table, the executor that
training and serving run, the analytic latency of the same program, and
the Eq. 7/8 schedule recurrence that the batched latency model shares).

A cut configuration compiles once into per-group client heads, a
sequence of server steps with explicit join/depart barriers, and
per-group client tails. ``make_apply`` executes it:

* heads and tails run each profile group's stacked clients as one call
  with per-client weights, so their BatchNorm statistics are per
  client;
* each server step concatenates the rows of every active group, in
  group order and client-major (``join_rows``: the one copy where rows
  change owner), so server BatchNorm statistics span the population
  (``concat_groups=True``, the paper's Eq. 7 join); with
  ``concat_groups=False`` each group runs through the shared server
  weights on its own, so the statistics are per group ("ghost BN") and
  the server's new running statistics are their equal-weight mean;
* on a rank of a client-sharded step (``reduce=``) the program runs the
  rank's rows of every group, and each server BatchNorm sums its
  statistics over the ranks, so they span the same rows as unsharded;
* the captured middle is each client's batch mean of the middle
  layer's output, flattened in H, W, C order.

With ``train=False`` every BatchNorm uses its running statistics, so
each output row depends on its own input row alone: the serving
engine's bucket-padding rows cannot touch valid rows.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.latency import PAPER_SERVER, DeviceProfile
from repro_torch.core.splitting import (ProfileGroup, bucket_size, layer_pair,
                                        server_union_span)
from repro_torch.models import nn
from repro_torch.models.gan import NET_LAYER_COSTS, NET_LAYER_DEFS
from repro_torch.sharding.policy import maybe_shard
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


def head_pass(defs, params, x, stop: int, train: bool):
    """A client head: layers ``[0, stop)`` on the group's stacked
    clients; returns (activations, {str(layer): new params})."""
    new = {}
    for l in range(stop):
        x, new[str(l)] = defs[l].apply(params[str(l)], x, train)
    return x, new


def tail_pass(defs, params, x, start: int, n: int, train: bool):
    """A client tail: layers ``[start, n)``, as ``head_pass``."""
    new = {}
    for l in range(start, n):
        x, new[str(l)] = defs[l].apply(params[str(l)], x, train)
    return x, new


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [k, b, ...] as rows [k*b, ...]: a view where they lie
    client-major, else one copy (counted in ``nn.layout_copies``)."""
    k, b = x.shape[:2]
    if k > 1 and b > 1 and x.stride(0) != b * x.stride(1):
        nn.count_layout_copy()
    return x.reshape((-1,) + x.shape[2:])


def join_rows(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The active groups' activations (each ``[k, b, ...]``, in group
    order) as one batch of rows ``[sum k*b, ...]``, client-major: one
    copy where rows change owner (several groups join, or one group's
    clients are stored client-minor, as a client convolution leaves
    them), counted in ``nn.layout_copies``; a view where one group's rows
    already lie so (a server layer's output, G's dense layer 0). Groups
    of unequal batches join as rows, each copied once more where it is
    client-minor."""
    if len(xs) == 1:
        x = _rows(xs[0])
    elif len({x.shape[1:] for x in xs}) == 1:
        nn.count_layout_copy()
        x = _rows(torch.cat(xs, 0))
    else:
        nn.count_layout_copy()
        x = torch.cat([_rows(x) for x in xs], 0)
    return maybe_shard(x, "rows")


def _server_layer(layer_def, params, x, train: bool, reduce=None):
    """A shared server layer on concatenated rows [N, ...]: run it as a
    single copy (K = 1) of the client-batched layer; ``reduce`` sums its
    BatchNorm statistics over the ranks that hold the other rows
    (``nn.one_rank`` without it: the statistics take the same path
    sharded or not, ``nn.batchnorm_apply``)."""
    y, upd = layer_def.apply(tree_map(lambda t: t[None], params), x[None],
                             train,
                             reduce=nn.one_rank if reduce is None else reduce)
    return maybe_shard(y[0], "rows"), tree_map(lambda t: t[0], upd)


def _mean_stats(params, updates):
    """Ghost BatchNorm's merge: each running statistic ('mean'/'var') is
    the equal-weight mean of the groups' updates, summed in group order
    as the reference's ``sum(xs) / len(xs)``; every other leaf is the
    layer's own parameter, which a forward pass returns unchanged."""
    out = {}
    for k, v in params.items():
        ups = [u[k] for u in updates]
        if isinstance(v, dict):
            out[k] = _mean_stats(v, ups)
        elif k in ("mean", "var"):
            out[k] = (ups[0] if len(ups) == 1
                      else functools.reduce(torch.add, ups) / len(ups))
        else:
            out[k] = v
    return out


def server_pass(layer_def, params, xs: Sequence[torch.Tensor], train: bool,
                concat_groups: bool = True, reduce=None):
    """One shared server layer over the active groups' activations ``xs``
    (each ``[k, b, ...]``, in group order): returns (each group's output
    ``[k, b, ...]``, views of the layer's output rows, and the layer's
    new params). ``concat_groups`` runs the rows as one batch
    (``join_rows``); otherwise each group runs on its own and the
    statistics merge by ``_mean_stats``. ``reduce`` (a client-sharded
    step's ``launch.mesh.reduce_sum`` over the mesh) sums each
    BatchNorm's statistics over the ranks, which hold the other rows of
    every group."""
    if not concat_groups:
        runs = [_server_layer(layer_def, params, join_rows([x]), train,
                              reduce) for x in xs]
        return ([y.unflatten(0, x.shape[:2]) for (y, _), x in zip(runs, xs)],
                _mean_stats(params, [u for _, u in runs]))
    y, new = _server_layer(layer_def, params, join_rows(xs), train, reduce)
    rows = torch.split(y, [x.shape[0] * x.shape[1] for x in xs], 0)
    return [r.unflatten(0, x.shape[:2]) for r, x in zip(rows, xs)], new


def make_apply(program: SplitProgram, capture_middle: bool = False,
               concat_groups: bool = True, reduce=None) -> Callable:
    """Returns ``apply(client_params, server_params, inputs, train) ->
    (outputs {gname: [K, b, ...]}, new_client, new_server, middles)``
    with ``inputs`` = {gname: tuple of per-client-stacked tensors fed
    to layer 0}. ``concat_groups=False`` is the no-concat server
    schedule (per-group BatchNorm statistics, see the module
    docstring). ``reduce`` runs the program on a rank's rows of a
    client-sharded step: the server layers' statistics are summed over
    the ranks with it (``server_pass``)."""
    defs = NET_LAYER_DEFS[program.net]
    n = program.n_layers
    middle = program.middle

    def apply(client_params, server_params, inputs, train: bool):
        new_client = {name: dict(client_params[name])
                      for name in program.group_names}
        new_server = dict(server_params)
        bufs: Dict[str, torch.Tensor] = {}
        for seg in program.heads:
            bufs[seg.gname], upd = head_pass(defs, client_params[seg.gname],
                                             inputs[seg.gname], seg.stop,
                                             train)
            new_client[seg.gname].update(upd)
        outs: Dict[str, torch.Tensor] = {}
        middles: Dict[str, torch.Tensor] = {}
        for step in program.steps:
            l = step.layer
            parts, new_server[str(l)] = server_pass(
                defs[l], server_params[str(l)],
                [bufs[gname] for gname in step.active], train, concat_groups,
                reduce)
            for gname, part in zip(step.active, parts):
                bufs[gname] = part
                if capture_middle and l == middle:
                    middles[gname] = part.flatten(2).float().mean(1)
                if gname in step.departs:
                    outs[gname] = part
        results: Dict[str, torch.Tensor] = {}
        for seg in program.tails:
            results[seg.gname], upd = tail_pass(
                defs, client_params[seg.gname], outs[seg.gname], seg.start,
                n, train)
            new_client[seg.gname].update(upd)
        return results, new_client, new_server, middles

    return apply


# ---------------------------------------------------------------------------
# Eq. 7/8 schedule recurrence (shared with core.latency_device)
# ---------------------------------------------------------------------------

def join_barrier_scan(terms: torch.Tensor, barriers: torch.Tensor,
                      reverse: bool = False) -> torch.Tensor:
    """Eq. 7/8 cumulative server schedule over the last (layer) axis of
    ``[..., n]`` tensors: ``S[i+1] = max(S[i] + terms[i], barriers[i])``
    from a float32 0, swept top-down with ``reverse=True`` for the
    backward Eq. 8. Returns the ``[..., n]`` cumulative values in layer
    order; leading axes (a GA population) are batched. ``n`` is static
    (5 layers), so the loop unrolls."""
    n = terms.shape[-1]
    s = torch.zeros(terms.shape[:-1], dtype=torch.float32,
                    device=terms.device)
    out = [None] * n
    for i in (range(n - 1, -1, -1) if reverse else range(n)):
        s = torch.maximum(s + terms[..., i], barriers[..., i])
        out[i] = s
    return torch.stack(out, -1)


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


def program_iteration_latency(prog_g: SplitProgram, prog_d: SplitProgram,
                              profiles: Mapping[str, DeviceProfile],
                              server: DeviceProfile = PAPER_SERVER,
                              batch: int = 64) -> float:
    """Eq. 10 from two compiled programs: L = gf + gb + 3 (df + db)."""
    gf, gb = program_net_latency(prog_g, profiles, server, batch)
    df, db = program_net_latency(prog_d, profiles, server, batch)
    return gf + gb + 3.0 * (df + db)


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
