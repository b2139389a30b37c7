"""Clustered, KLD-weighted, layer-wise federated aggregation — Eq. (16)
(port of the dense single-device round of ``repro.core.federation``).

Client-side segments are aggregated within clusters and layer-wise over
each layer's owners: for layer l and cluster C, every client in C that
holds l contributes its copy with its normalized weight, and all owners
receive the aggregate.

A cached ``FederationPlan`` packs every profile group's stacked client
segments into one ``theta [K, D]`` float32 buffer per net (one row per
client copy, one column run per ownable layer, zero where a cut does not
own the layer; leaves in sorted-key order). The round is then
``A @ theta`` with ``A [S, K]`` one normalized reduce row per (layer,
cluster) segment, S padded to a multiple of 8, followed by a gather of
each copy's segment row and an unflatten. With ``use_kernel`` the
product is kernel K1.

The chunked stream, mesh sharding and cohorts of the reference are not
ported yet (ROADMAP); ``chunk_size``, ``mesh`` and ``cohort_mask``
raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.splitting import (ProfileGroup, client_owned_layers,
                                        layer_pair)
from repro_torch.kernels import ops as kops
from repro_torch.models.gan import DISC_LAYER_DEFS, GEN_LAYER_DEFS
from repro_torch.tree import tree_from_items, tree_items

_SEGMENT_PAD = 8
N_LAYERS = {"G": len(GEN_LAYER_DEFS), "D": len(DISC_LAYER_DEFS)}


@dataclasses.dataclass(frozen=True)
class _LeafSpec:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]      # per-copy shape (no leading K axis)
    size: int


@dataclasses.dataclass(frozen=True)
class _SegmentEntry:
    """One (group, layer) tile of the flat buffer."""
    layer: int
    gname: str
    row0: int
    row1: int
    col0: int
    width: int
    sid0: int                   # slice into the per-copy segment-id vec
    sid1: int
    leaves: Tuple[_LeafSpec, ...]


def _unsupported(chunk_size=None, mesh=None, cohort_mask=None) -> None:
    if chunk_size is not None:
        raise NotImplementedError("chunk-streamed aggregation is not ported "
                                  "yet (ROADMAP M6c, chunked stream)")
    if mesh is not None:
        raise NotImplementedError("mesh-sharded federation is not ported "
                                  "(ROADMAP M10, mesh code)")
    if cohort_mask is not None:
        raise NotImplementedError("cohort rounds are not ported yet "
                                  "(ROADMAP M6b, cohorts/registry)")


class FederationPlan:
    """Flattening/aggregation plan for one (net, topology), built once
    from a template of the client params and reused every round."""

    def __init__(self, groups: Sequence[ProfileGroup], net: str,
                 n_layers: int, template: Dict[str, Dict[str, Any]]):
        self.net = net
        self.n_layers = n_layers
        self._group_rows: Dict[str, Tuple[int, int]] = {}
        self.row_cids: List[int] = []
        row = 0
        for g in groups:
            self._group_rows[g.name] = (row, row + g.size)
            self.row_cids.extend(g.client_ids)
            row += g.size
        self.n_rows = row
        owned = {g.name: client_owned_layers(layer_pair(g.cut, net), n_layers)
                 for g in groups}
        layers = sorted({l for ls in owned.values() for l in ls})

        self._col_runs: Dict[int, Tuple[int, int]] = {}
        layer_specs: Dict[int, Tuple[_LeafSpec, ...]] = {}
        col = 0
        for l in layers:
            for g in groups:
                if l not in owned[g.name]:
                    continue
                specs = tuple(
                    _LeafSpec(path, tuple(x.shape[1:]),
                              int(np.prod(x.shape[1:], dtype=np.int64)))
                    for path, x in tree_items(template[g.name][str(l)]))
                if l not in layer_specs:
                    layer_specs[l] = specs
                elif layer_specs[l] != specs:
                    raise ValueError(f"layer {l} leaf layout differs across "
                                     f"groups (group {g.name})")
            width = sum(s.size for s in layer_specs[l])
            self._col_runs[l] = (col, width)
            col += width
        self.n_cols = col

        self.entries: List[_SegmentEntry] = []
        sid = 0
        for g in groups:
            r0, r1 = self._group_rows[g.name]
            for l in owned[g.name]:
                c0, w = self._col_runs[l]
                self.entries.append(_SegmentEntry(
                    l, g.name, r0, r1, c0, w, sid, sid + g.size,
                    layer_specs[l]))
                sid += g.size
        self.n_copies = sid

        self._layer_rows: List[Tuple[int, np.ndarray, np.ndarray]] = []
        cids_arr = np.asarray(self.row_cids, np.int64)
        for l in layers:
            rows = np.concatenate([
                np.arange(*self._group_rows[g.name]) for g in groups
                if l in owned[g.name]])
            self._layer_rows.append((l, rows, cids_arr[rows]))
        layer_pos = {l: i for i, (l, _, _) in enumerate(self._layer_rows)}
        self._copy_layer_pos = np.zeros(self.n_copies, np.int64)
        self._copy_cid = np.zeros(self.n_copies, np.int64)
        for e in self.entries:
            self._copy_layer_pos[e.sid0:e.sid1] = layer_pos[e.layer]
            self._copy_cid[e.sid0:e.sid1] = cids_arr[e.row0:e.row1]
        self._owned = owned
        self._groups_order = [g.name for g in groups]
        self._index_cache: Dict[torch.device, Tuple] = {}

    def _indices(self, device: torch.device):
        """Per-layer owner rows/cids and per-copy maps as device tensors,
        uploaded once per device."""
        idx = self._index_cache.get(device)
        if idx is None:
            def t(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)
            idx = self._index_cache[device] = (
                [(l, t(rows), t(cids)) for l, rows, cids in self._layer_rows],
                t(self._copy_layer_pos), t(self._copy_cid))
        return idx

    def num_segments(self, num_clusters: int) -> int:
        n_seg = len(self._layer_rows) * int(num_clusters)
        return max(_SEGMENT_PAD, -(-n_seg // _SEGMENT_PAD) * _SEGMENT_PAD)

    # -- host weight matrix (Eq. 15/16 block diagonal) ----------------------
    def weight_segments(self, weights: np.ndarray, cluster_labels: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(A [S, K], seg_ids [n_copies]) for the clusters present; a
        segment whose weights sum to zero goes uniform over its
        members."""
        rows_a: List[np.ndarray] = []
        seg_of: Dict[Tuple[int, int], int] = {}
        for l, rows, cids in self._layer_rows:
            for c in np.unique(cluster_labels[cids]):
                sel = cluster_labels[cids] == c
                w = np.asarray(weights, np.float64)[cids[sel]]
                if w.sum() <= 0:
                    w = np.ones_like(w)
                w = w / w.sum()
                a = np.zeros(self.n_rows, np.float32)
                a[rows[sel]] = w.astype(np.float32)
                seg_of[(l, int(c))] = len(rows_a)
                rows_a.append(a)
        seg_ids = np.zeros(self.n_copies, np.int64)
        for e in self.entries:
            row_cids = self.row_cids[e.row0:e.row1]
            seg_ids[e.sid0:e.sid1] = [
                seg_of[(e.layer, int(cluster_labels[cid]))]
                for cid in row_cids]
        S = max(_SEGMENT_PAD,
                -(-len(rows_a) // _SEGMENT_PAD) * _SEGMENT_PAD)
        A = np.zeros((S, self.n_rows), np.float32)
        if rows_a:
            A[:len(rows_a)] = np.stack(rows_a)
        return A, seg_ids

    # -- device weight matrix -------------------------------------------------
    def device_weight_segments(self, weights: torch.Tensor,
                               labels: torch.Tensor, num_clusters: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A [S, K], seg_ids) from device weights/labels: one segment
        row per (layer, cluster id < num_clusters), so S is fixed by the
        static bound. Empty segments stay zero and are never gathered;
        a present segment whose weights sum to zero goes uniform."""
        C = int(num_clusters)
        layer_rows, copy_lpos, copy_cid = self._indices(weights.device)
        A = torch.zeros((self.num_segments(C), self.n_rows),
                        dtype=torch.float32, device=weights.device)
        w = weights.float()
        lab_all = labels.long()
        for li, (_, rows, cids) in enumerate(layer_rows):
            onehot = F.one_hot(lab_all[cids], C).float()          # [R, C]
            raw = onehot * w[cids][:, None]
            denom = raw.sum(0)
            cnt = onehot.sum(0)
            blk = torch.where(denom > 0,
                              raw / torch.where(denom > 0, denom,
                                                torch.ones_like(denom)),
                              onehot / torch.clamp_min(cnt, 1.0))
            A[li * C:(li + 1) * C, rows] = blk.T
        seg_ids = copy_lpos * C + lab_all[copy_cid]
        return A, seg_ids

    # -- flatten / unflatten ----------------------------------------------------
    def flatten(self, net_params: Dict[str, Dict[str, Any]],
                device: torch.device) -> torch.Tensor:
        bufs = []
        for gname in self._groups_order:
            r0, r1 = self._group_rows[gname]
            k = r1 - r0
            parts = []
            for l, (c0, w) in sorted(self._col_runs.items()):
                if l in self._owned[gname]:
                    parts.extend(
                        x.reshape(k, -1).float()
                        for _, x in tree_items(net_params[gname][str(l)]))
                else:
                    parts.append(torch.zeros((k, w), dtype=torch.float32,
                                             device=device))
            bufs.append(torch.cat(parts, 1))
        return torch.cat(bufs, 0)

    def unflatten(self, agg: torch.Tensor, seg_ids: torch.Tensor
                  ) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for e in self.entries:
            block = agg[seg_ids[e.sid0:e.sid1], e.col0:e.col0 + e.width]
            offs = np.cumsum([0] + [s.size for s in e.leaves])
            tree = tree_from_items(
                (s.path, block[:, o:o + s.size]
                 .reshape((e.row1 - e.row0,) + s.shape))
                for s, o in zip(e.leaves, offs))
            out.setdefault(e.gname, {})[str(e.layer)] = tree
        return out

    # -- the round ----------------------------------------------------------------
    def _reduce(self, A: torch.Tensor, theta: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
        return kops.clustered_agg(A, theta) if use_kernel else A @ theta

    def aggregate(self, net_params: Dict[str, Dict[str, Any]],
                  A: np.ndarray, seg_ids: np.ndarray,
                  use_kernel: bool = False) -> Dict[str, Dict[str, Any]]:
        device = _params_device(net_params)
        theta = self.flatten(net_params, device)
        A_t = torch.as_tensor(A, dtype=torch.float32, device=device)
        agg = self._reduce(A_t, theta, use_kernel)
        return self.unflatten(agg, torch.as_tensor(seg_ids, device=device))

    def aggregate_device(self, net_params: Dict[str, Dict[str, Any]],
                         weights: torch.Tensor, labels: torch.Tensor,
                         num_clusters: int, use_kernel: bool = False
                         ) -> Dict[str, Dict[str, Any]]:
        A, seg_ids = self.device_weight_segments(weights, labels,
                                                 num_clusters)
        theta = self.flatten(net_params, weights.device)
        return self.unflatten(self._reduce(A, theta, use_kernel), seg_ids)


def _params_device(net_params) -> torch.device:
    for tree in net_params.values():
        for _, x in tree_items(tree):
            return x.device
    raise ValueError("empty client params")


def _plan_key(groups: Sequence[ProfileGroup], net: str, n_layers: int,
              template: Dict[str, Dict[str, Any]]) -> Tuple:
    layout = tuple(
        (g.name, tuple(
            (l, tuple((path, tuple(x.shape)) for path, x in tree_items(tree)))
            for l, tree in sorted(template[g.name].items())))
        for g in groups)
    return (net, n_layers, tuple(
        (g.name, g.cut.as_tuple(), tuple(g.client_ids)) for g in groups),
        layout)


def get_federation_plan(groups: Sequence[ProfileGroup], net: str,
                        n_layers: int, template: Dict[str, Dict[str, Any]],
                        plan_cache: Dict) -> FederationPlan:
    key = _plan_key(groups, net, n_layers, template)
    if key not in plan_cache:
        plan_cache[key] = FederationPlan(groups, net, n_layers, template)
    return plan_cache[key]


def federate_client_params(groups: Sequence[ProfileGroup],
                           client_params: Dict[str, Dict[str, Dict[str, Any]]],
                           weights: np.ndarray, cluster_labels: np.ndarray,
                           n_layers: Dict[str, int] = None,
                           use_kernel: bool = False,
                           plan_cache: Optional[Dict] = None,
                           chunk_size: Optional[int] = None,
                           mesh: Any = None,
                           cohort_mask: Optional[np.ndarray] = None
                           ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Aggregate client-held layers cluster-wise from host weights and
    labels (indexed by global client id). client_params: {group.name:
    {net: {str(layer): stacked tree}}}. Returns a new client_params with
    the aggregated copies broadcast back."""
    _unsupported(chunk_size, mesh, cohort_mask)
    n_layers = n_layers or N_LAYERS
    plan_cache = {} if plan_cache is None else plan_cache
    weights = np.asarray(weights)
    cluster_labels = np.asarray(cluster_labels)
    out = {gname: dict(nets) for gname, nets in client_params.items()}
    for net, n_lay in n_layers.items():
        template = {g.name: client_params[g.name][net] for g in groups}
        plan = get_federation_plan(groups, net, n_lay, template, plan_cache)
        if plan.n_rows == 0:
            continue
        A, seg_ids = plan.weight_segments(weights, cluster_labels)
        new_net = plan.aggregate(template, A, seg_ids, use_kernel=use_kernel)
        for g in groups:
            if g.name in new_net:
                out[g.name][net] = new_net[g.name]
    return out


def federate_client_params_device(
        groups: Sequence[ProfileGroup],
        client_params: Dict[str, Dict[str, Dict[str, Any]]],
        weights: torch.Tensor, cluster_labels: torch.Tensor,
        num_clusters: int, n_layers: Dict[str, int] = None,
        use_kernel: bool = False, plan_cache: Optional[Dict] = None,
        chunk_size: Optional[int] = None, mesh: Any = None,
        cohort_mask: Optional[torch.Tensor] = None
        ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Twin of ``federate_client_params`` taking device weights and
    labels (e.g. straight out of clustering); the weight matrix is
    built on the device. ``num_clusters`` is the static label-id bound
    (``clustering.k_selection_bound``)."""
    _unsupported(chunk_size, mesh, cohort_mask)
    n_layers = n_layers or N_LAYERS
    plan_cache = {} if plan_cache is None else plan_cache
    out = {gname: dict(nets) for gname, nets in client_params.items()}
    for net, n_lay in n_layers.items():
        template = {g.name: client_params[g.name][net] for g in groups}
        plan = get_federation_plan(groups, net, n_lay, template, plan_cache)
        if plan.n_rows == 0:
            continue
        new_net = plan.aggregate_device(template, weights, cluster_labels,
                                        num_clusters, use_kernel=use_kernel)
        for g in groups:
            if g.name in new_net:
                out[g.name][net] = new_net[g.name]
    return out


def fedavg_uniform(groups: Sequence[ProfileGroup],
                   client_params: Dict[str, Dict[str, Dict[str, Any]]],
                   sizes: np.ndarray, n_layers: Dict[str, int] = None,
                   use_kernel: bool = False,
                   plan_cache: Optional[Dict] = None,
                   chunk_size: Optional[int] = None, mesh: Any = None,
                   cohort_mask: Optional[np.ndarray] = None
                   ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Vanilla FedAvg (the warm-up rounds, paper §4.5): one global
    cluster, weights proportional to dataset size."""
    _unsupported(chunk_size, mesh, cohort_mask)
    sizes = np.asarray(sizes, np.float64)
    return federate_client_params(groups, client_params, sizes / sizes.sum(),
                                  np.zeros(len(sizes), np.int64),
                                  n_layers=n_layers, use_kernel=use_kernel,
                                  plan_cache=plan_cache)
