"""Clustered, KLD-weighted, layer-wise federated aggregation — Eq. (16)
(port of the single-device rounds of ``repro.core.federation``).

Client-side segments are aggregated within clusters and layer-wise over
each layer's owners: for layer l and cluster C, every client in C that
holds l contributes its copy with its normalized weight, and all owners
receive the aggregate.

A cached ``FederationPlan`` packs every profile group's stacked client
segments into one ``theta [K, D]`` float32 buffer per net (one row per
client copy, one column run per ownable layer, zero where a cut does not
own the layer; leaves in sorted-key order). The dense round is then
``A @ theta`` with ``A [S, K]`` one normalized reduce row per (layer,
cluster) segment, S padded to a multiple of 8, followed by a gather of
each copy's segment row and an unflatten. With ``use_kernel`` the
product is kernel K1. Every flat buffer the plan allocates (``theta``,
the chunk stream's ``theta_c`` and ``acc``) pads its rows to a multiple
of 32 floats (``row_stride``), so each row starts on a 128-byte
boundary and K1 copies it 16 bytes at a time; the plan hands out the
``[:, :n_cols]`` view, and the pad columns are zero and never read back.

Chunk-streamed round (``chunk_size=``, ``FederationPlan.aggregate_chunked``):
the dense ``[K, D]`` buffer is never built. Each profile group's rows
stream in chunks of c clients; every chunk contracts one ``A_c [S, c] @
theta_c [c, D]`` tile (K1 with ``use_kernel``) into a running ``(acc
[S, D], mass [S])``, and one normalize at the end divides them out. The
working set is O(c + clusters), independent of the client count, and
the re-associated float32 sums agree with the dense round within
tolerance, not bit for bit. The reference pads group sizes to
power-of-two buckets so that JAX can share compiled programs across
populations; padded rows add exact zeros, so the port, which compiles
nothing, streams the actual rows in the same order (groups, then
chunks, then rows within a chunk).

Cohort rounds (``cohort_mask=``, [K] bool): the weights must already be
renormalized over the cohort (``kld.cohort_federation_weights``, zero
outside it); the uniform fallback of a zero-mass segment covers its
participating members only, and every copy of a non-member keeps its
pre-round values bit for bit (the recv-select of the unflatten), as
does every copy of a (layer, cluster) whose cohort is empty.

The legacy loop (``federate_client_params(fused=False)``,
``_federate_client_params_legacy``) is the reference's correctness
oracle: net x layer x cluster x member, one weighted average per (layer,
cluster) (``weighted_average_stacked``, K1's S = 1 case with
``use_kernel``) scattered back to every member; full-participation dense
rounds only.

Mesh sharding (M10) is not ported; ``mesh=`` raises.
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
from repro_torch.tree import tree_from_items, tree_items, tree_map

_SEGMENT_PAD = 8
_ROW_ALIGN = 32                 # floats: flat-buffer rows start on 128 B
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


def _unsupported(mesh=None) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh-sharded federation is not ported "
                                  "(ROADMAP M10, mesh code)")


def _padded_segments(n_seg: int) -> int:
    return max(_SEGMENT_PAD, -(-n_seg // _SEGMENT_PAD) * _SEGMENT_PAD)


def row_stride(cols: int) -> int:
    """Row stride, in floats, of the plan's flat buffers of ``cols``
    columns: a multiple of ``_ROW_ALIGN``."""
    return max(_ROW_ALIGN, -(-cols // _ROW_ALIGN) * _ROW_ALIGN)


def padded_rows(n: int, cols: int, device: torch.device) -> torch.Tensor:
    """An [n, cols] float32 view of a buffer whose rows are padded to
    ``row_stride(cols)`` floats, so that every row starts on a 16-byte
    boundary and K1 copies it 16 bytes at a time; the pad columns are
    zero, the rest uninitialized."""
    buf = torch.empty((n, row_stride(cols)), dtype=torch.float32,
                      device=device)
    buf[:, cols:].zero_()
    return buf[:, :cols]


def weighted_average_stacked(stacked: Any, weights: torch.Tensor,
                             use_kernel: bool = False) -> Any:
    """Weighted sum over the leading client axis of every leaf, in
    float32, cast back to the leaf's dtype; ``weights`` [K] must already
    be normalized. ``use_kernel`` runs K1's S = 1 entry point."""
    if use_kernel:
        return tree_map(lambda x: kops.weighted_agg(x, weights), stacked)
    w = weights.float()
    return tree_map(lambda x: torch.einsum("k,k...->...", w, x.float()
                                           ).to(x.dtype), stacked)


class FederationPlan:
    """Flattening/aggregation plan for one (net, topology), built once
    from a template of the client params and reused every round.
    ``chunk_size`` enables ``aggregate_chunked``."""

    def __init__(self, groups: Sequence[ProfileGroup], net: str,
                 n_layers: int, template: Dict[str, Dict[str, Any]],
                 chunk_size: Optional[int] = None):
        self.net = net
        self.n_layers = n_layers
        if chunk_size is not None and int(chunk_size) < 1:
            raise ValueError(f"chunk_size {chunk_size} must be >= 1")
        self.chunk_size = None if chunk_size is None else int(chunk_size)
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
        self.row_stride = row_stride(col)

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
        self._owned_pos = {gname: [layer_pos[l] for l in ls]
                           for gname, ls in owned.items()}
        self._groups_order = [g.name for g in groups]
        self._index_cache: Dict[torch.device, Tuple] = {}

    def _indices(self, device: torch.device):
        """Per-layer owner rows/cids, per-copy maps and the row -> client
        id map as device tensors, uploaded once per device."""
        idx = self._index_cache.get(device)
        if idx is None:
            def t(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)
            idx = self._index_cache[device] = (
                [(l, t(rows), t(cids)) for l, rows, cids in self._layer_rows],
                t(self._copy_layer_pos), t(self._copy_cid),
                t(np.asarray(self.row_cids, np.int64)))
        return idx

    def num_segments(self, num_clusters: int) -> int:
        return _padded_segments(len(self._layer_rows) * int(num_clusters))

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
        A = np.zeros((_padded_segments(len(rows_a)), self.n_rows), np.float32)
        if rows_a:
            A[:len(rows_a)] = np.stack(rows_a)
        return A, seg_ids

    # -- device weight matrix -------------------------------------------------
    def device_weight_segments(self, weights: torch.Tensor,
                               labels: torch.Tensor, num_clusters: int,
                               participation: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A [S, K], seg_ids) from device weights/labels: one segment
        row per (layer, cluster id < num_clusters), so S is fixed by the
        static bound. Empty segments stay zero and are never gathered;
        a present segment whose weights sum to zero goes uniform over
        its participating members (``participation`` [K] 0/1, default
        all ones), and one with no participant gets a zero row."""
        C = int(num_clusters)
        layer_rows, copy_lpos, copy_cid, _ = self._indices(weights.device)
        A = torch.zeros((self.num_segments(C), self.n_rows),
                        dtype=torch.float32, device=weights.device)
        w = weights.float()
        part = (torch.ones_like(w) if participation is None
                else participation.float())
        lab_all = labels.long()
        for li, (_, rows, cids) in enumerate(layer_rows):
            onehot = F.one_hot(lab_all[cids], C).float()          # [R, C]
            raw = onehot * w[cids][:, None]
            denom = raw.sum(0)
            mem = onehot * part[cids][:, None]
            cnt = mem.sum(0)
            blk = torch.where(denom > 0,
                              raw / torch.where(denom > 0, denom,
                                                torch.ones_like(denom)),
                              mem / torch.clamp_min(cnt, 1.0))
            A[li * C:(li + 1) * C, rows] = blk.T
        seg_ids = copy_lpos * C + lab_all[copy_cid]
        return A, seg_ids

    # -- flatten / unflatten ----------------------------------------------------
    def flatten(self, net_params: Dict[str, Dict[str, Any]],
                device: torch.device) -> torch.Tensor:
        """The dense ``theta [K, n_cols]`` (rows padded to
        ``row_stride``): each group's copies of its owned layers' leaves
        in their column runs, zero elsewhere."""
        theta = padded_rows(self.n_rows, self.n_cols, device)
        for gname in self._groups_order:
            r0, r1 = self._group_rows[gname]
            for l, (c0, w) in sorted(self._col_runs.items()):
                if l not in self._owned[gname]:
                    theta[r0:r1, c0:c0 + w].zero_()
                    continue
                for _, x in tree_items(net_params[gname][str(l)]):
                    flat = x.reshape(r1 - r0, -1)
                    theta[r0:r1, c0:c0 + flat.shape[1]].copy_(flat)
                    c0 += flat.shape[1]
        return theta

    def unflatten(self, agg: torch.Tensor, seg_ids: torch.Tensor,
                  originals: Optional[Dict[str, Dict[str, Any]]] = None,
                  recv: Optional[torch.Tensor] = None
                  ) -> Dict[str, Dict[str, Any]]:
        """Gather each copy's segment row into new stacked trees.
        ``recv`` ([n_copies] bool, with ``originals`` the pre-round
        params): copies of clients outside the round's cohort keep their
        original leaves instead of a segment aggregate they took no part
        in."""
        out: Dict[str, Dict[str, Any]] = {}
        for e in self.entries:
            k = e.row1 - e.row0
            block = agg[seg_ids[e.sid0:e.sid1], e.col0:e.col0 + e.width]
            offs = np.cumsum([0] + [s.size for s in e.leaves])
            orig = (None if recv is None else
                    dict(tree_items(originals[e.gname][str(e.layer)])))
            items = []
            for s, o in zip(e.leaves, offs):
                leaf = block[:, o:o + s.size].reshape((k,) + s.shape)
                if recv is not None:
                    keep = recv[e.sid0:e.sid1].reshape(
                        (k,) + (1,) * len(s.shape))
                    leaf = torch.where(keep, leaf, orig[s.path])
                items.append((s.path, leaf))
            out.setdefault(e.gname, {})[str(e.layer)] = tree_from_items(items)
        return out

    def _recv_args(self, net_params, cohort_mask, copy_cid):
        """(originals, recv) for ``unflatten``: the per-copy participation
        of a cohort round, nothing for a full round."""
        if cohort_mask is None:
            return None, None
        return net_params, cohort_mask.bool()[copy_cid]

    # -- the dense round ----------------------------------------------------------
    def _reduce(self, A: torch.Tensor, theta: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
        return kops.clustered_agg(A, theta) if use_kernel else A @ theta

    def aggregate(self, net_params: Dict[str, Dict[str, Any]],
                  A: np.ndarray, seg_ids: np.ndarray,
                  use_kernel: bool = False,
                  cohort_mask: Optional[np.ndarray] = None
                  ) -> Dict[str, Dict[str, Any]]:
        """Round from the host weight matrix; ``cohort_mask`` ([K] bool,
        host) restores non-members' copies."""
        device = _params_device(net_params)
        _, _, copy_cid, _ = self._indices(device)
        A_t = torch.as_tensor(A, dtype=torch.float32, device=device)
        agg = self._reduce(A_t, self.flatten(net_params, device), use_kernel)
        mask = (None if cohort_mask is None else
                torch.as_tensor(np.asarray(cohort_mask, bool), device=device))
        return self.unflatten(agg, torch.as_tensor(seg_ids, device=device),
                              *self._recv_args(net_params, mask, copy_cid))

    def aggregate_device(self, net_params: Dict[str, Dict[str, Any]],
                         weights: torch.Tensor, labels: torch.Tensor,
                         num_clusters: int, use_kernel: bool = False,
                         cohort_mask: Optional[torch.Tensor] = None
                         ) -> Dict[str, Dict[str, Any]]:
        """Round from device weights/labels (label ids < the static
        ``num_clusters``). With ``cohort_mask`` ([K] bool, weights
        renormalized over the cohort) non-members keep their params."""
        _, _, copy_cid, _ = self._indices(weights.device)
        A, seg_ids = self.device_weight_segments(
            weights, labels, num_clusters, participation=cohort_mask)
        agg = self._reduce(A, self.flatten(net_params, weights.device),
                           use_kernel)
        return self.unflatten(agg, seg_ids, *self._recv_args(
            net_params, cohort_mask, copy_cid))

    # -- the chunk-streamed round -----------------------------------------------
    def _accumulate_chunks(self, net_params, w_all, lab_all, part_all,
                           zero_seg, num_clusters: int, use_kernel: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stream every group's rows in chunks of ``chunk_size``, adding
        one ``A_c [S, c] @ theta_c [c, D]`` tile per chunk into ``(acc
        [S, D], mass [S])`` in place. ``theta_c`` and ``A_c`` are
        allocated once per round: columns of layers the group does not
        own and the rows past a tail chunk's end are zero, and so are
        those rows' weights. ``zero_seg`` [S] marks segments whose raw
        weight mass is zero but that have participating members: their
        members switch to their ``part_all`` value (1 in the cohort, 0
        outside), the dense round's uniform-over-participants
        fallback."""
        C = int(num_clusters)
        c = self.chunk_size
        dev = w_all.device
        _, _, _, row_cids = self._indices(dev)
        S = zero_seg.shape[0]
        acc = padded_rows(S, self.n_cols, dev).zero_()
        mass = torch.zeros(S, dtype=torch.float32, device=dev)
        theta_c = padded_rows(c, self.n_cols, dev)
        A_c = torch.empty((S, c), dtype=torch.float32, device=dev)
        cols = torch.arange(c, device=dev)
        for gname in self._groups_order:
            r0, r1 = self._group_rows[gname]
            Kg = r1 - r0
            if Kg == 0:
                continue
            leaves = []                      # (column offset, [Kg, size])
            for l, (c0, w) in sorted(self._col_runs.items()):
                if l in self._owned[gname]:
                    for _, x in tree_items(net_params[gname][str(l)]):
                        flat = x.reshape(Kg, -1)
                        leaves.append((c0, flat))
                        c0 += flat.shape[1]
                else:
                    theta_c[:, c0:c0 + w].zero_()
            for lo in range(0, Kg, c):
                r = min(c, Kg - lo)
                for off, flat in leaves:
                    theta_c[:r, off:off + flat.shape[1]].copy_(flat[lo:lo + r])
                if r < c:
                    theta_c[r:].zero_()
                cid_c = row_cids[r0 + lo:r0 + lo + r]
                lab_c = lab_all[cid_c]
                w_c, fb_c = w_all[cid_c], part_all[cid_c]
                A_c.zero_()
                for li in self._owned_pos[gname]:
                    seg = li * C + lab_c
                    A_c[seg, cols[:r]] = torch.where(zero_seg[seg], fb_c, w_c)
                acc += self._reduce(A_c, theta_c, use_kernel)
                mass += A_c.sum(1)
        return acc, mass

    def aggregate_chunked(self, net_params: Dict[str, Dict[str, Any]],
                          weights: torch.Tensor, labels: torch.Tensor,
                          num_clusters: int, use_kernel: bool = False,
                          cohort_mask: Optional[torch.Tensor] = None
                          ) -> Dict[str, Dict[str, Any]]:
        """Chunk-streamed round (the plan must be built with
        ``chunk_size=``): the semantics of ``aggregate_device``, but the
        dense ``[K, D]`` buffer is never built. Partial sums and weight
        masses accumulate over the chunks and one normalize at the end
        divides them out (in place in ``acc``)."""
        if self.chunk_size is None:
            raise ValueError("plan was built without chunk_size; pass "
                             "chunk_size= to get_federation_plan")
        C = int(num_clusters)
        dev = weights.device
        _, copy_lpos, copy_cid, _ = self._indices(dev)
        S = self.num_segments(C)
        w_all = weights.float()
        lab_all = labels.long()
        part = (torch.ones_like(w_all) if cohort_mask is None
                else cohort_mask.float())
        seg_of_copy = copy_lpos * C + lab_all[copy_cid]
        zeros = torch.zeros(S, dtype=torch.float32, device=dev)
        raw = zeros.index_add(0, seg_of_copy, w_all[copy_cid])
        cnt = zeros.index_add(0, seg_of_copy, part[copy_cid])
        zero_seg = (raw <= 0) & (cnt > 0)
        acc, mass = self._accumulate_chunks(net_params, w_all, lab_all, part,
                                            zero_seg, C, use_kernel)
        agg = acc.div_(torch.clamp_min(mass, 1e-20)[:, None])
        return self.unflatten(agg, seg_of_copy, *self._recv_args(
            net_params, cohort_mask, copy_cid))

    # -- memory envelopes ---------------------------------------------------------
    def dense_buffer_bytes(self) -> int:
        """float32 bytes allocated for the dense ``theta [K, D]`` flat
        client buffer of the dense rounds, rows padded to ``row_stride``
        (the O(clients) term the chunk stream removes)."""
        return 4 * self.n_rows * self.row_stride

    def chunked_buffer_bytes(self, num_clusters: int) -> int:
        """float32 bytes allocated for the chunk stream's working set:
        one ``theta_c [c, D]`` and ``A_c [S, c]`` tile plus ``(acc [S, D],
        mass [S])``, rows of D padded to ``row_stride``; O(chunk +
        clusters), independent of the client count."""
        if self.chunk_size is None:
            raise ValueError("plan was built without chunk_size")
        S = self.num_segments(num_clusters)
        c = self.chunk_size
        ld = self.row_stride
        return 4 * (c * ld + S * c + S * ld + S)


def _params_device(net_params) -> torch.device:
    for tree in net_params.values():
        for _, x in tree_items(tree):
            return x.device
    raise ValueError("empty client params")


def _plan_key(groups: Sequence[ProfileGroup], net: str, n_layers: int,
              template: Dict[str, Dict[str, Any]],
              chunk_size: Optional[int] = None) -> Tuple:
    layout = tuple(
        (g.name, tuple(
            (l, tuple((path, tuple(x.shape)) for path, x in tree_items(tree)))
            for l, tree in sorted(template[g.name].items())))
        for g in groups)
    return (net, n_layers, tuple(
        (g.name, g.cut.as_tuple(), tuple(g.client_ids)) for g in groups),
        layout, chunk_size)


def get_federation_plan(groups: Sequence[ProfileGroup], net: str,
                        n_layers: int, template: Dict[str, Dict[str, Any]],
                        plan_cache: Dict,
                        chunk_size: Optional[int] = None) -> FederationPlan:
    key = _plan_key(groups, net, n_layers, template, chunk_size)
    if key not in plan_cache:
        plan_cache[key] = FederationPlan(groups, net, n_layers, template,
                                         chunk_size=chunk_size)
    return plan_cache[key]


def federate_client_params(groups: Sequence[ProfileGroup],
                           client_params: Dict[str, Dict[str, Dict[str, Any]]],
                           weights: np.ndarray, cluster_labels: np.ndarray,
                           n_layers: Dict[str, int] = None,
                           use_kernel: bool = False,
                           fused: bool = True,
                           plan_cache: Optional[Dict] = None,
                           chunk_size: Optional[int] = None,
                           mesh: Any = None,
                           cohort_mask: Optional[np.ndarray] = None
                           ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Aggregate client-held layers cluster-wise from host weights and
    labels (indexed by global client id). client_params: {group.name:
    {net: {str(layer): stacked tree}}}. ``fused=True`` runs the plan's
    flat-buffer round (one K1 launch per net with ``use_kernel``);
    ``fused=False`` the legacy per-(layer, cluster) loop, the
    correctness oracle of full-participation dense rounds.
    ``chunk_size=c`` streams the round in c-client chunks;
    ``cohort_mask`` ([n_clients] bool) runs a sampled-cohort round, with
    ``weights`` already renormalized over the cohort
    (``kld.cohort_federation_weights_np``, zero outside it). Returns a
    new client_params with the aggregated copies broadcast back."""
    _unsupported(mesh)
    n_layers = n_layers or N_LAYERS
    if not fused:
        if chunk_size is not None or cohort_mask is not None:
            raise ValueError("the legacy loop is a full-participation "
                             "dense oracle: chunk_size/cohort_mask "
                             "require fused=True")
        return _federate_client_params_legacy(
            groups, client_params, weights, cluster_labels,
            n_layers=n_layers, use_kernel=use_kernel)
    plan_cache = {} if plan_cache is None else plan_cache
    weights = np.asarray(weights)
    cluster_labels = np.asarray(cluster_labels)
    out = {gname: dict(nets) for gname, nets in client_params.items()}
    for net, n_lay in n_layers.items():
        template = {g.name: client_params[g.name][net] for g in groups}
        plan = get_federation_plan(groups, net, n_lay, template, plan_cache,
                                   chunk_size=chunk_size)
        if plan.n_rows == 0:
            continue
        if chunk_size is not None:
            device = _params_device(template)
            new_net = plan.aggregate_chunked(
                template,
                torch.as_tensor(weights, dtype=torch.float32, device=device),
                torch.as_tensor(cluster_labels, dtype=torch.int64,
                                device=device),
                num_clusters=int(cluster_labels.max()) + 1,
                use_kernel=use_kernel,
                cohort_mask=None if cohort_mask is None else torch.as_tensor(
                    np.asarray(cohort_mask, bool), device=device))
        else:
            A, seg_ids = plan.weight_segments(weights, cluster_labels)
            new_net = plan.aggregate(template, A, seg_ids,
                                     use_kernel=use_kernel,
                                     cohort_mask=cohort_mask)
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
        cohort_mask: Optional[torch.Tensor] = None,
        cohort_size: Optional[int] = None
        ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Twin of ``federate_client_params`` taking device weights and
    labels (e.g. straight out of clustering); the weight matrix is
    built on the device. ``num_clusters`` is the static label-id bound
    (``clustering.k_selection_bound``). ``cohort_mask`` ([K] bool device
    tensor, weights renormalized over the cohort) runs a sampled-cohort
    round and comes with its ``cohort_size``, the number of clients
    sampled (the reference keys its compiled programs on it; here it
    only has to come with the mask)."""
    _unsupported(mesh)
    if (cohort_mask is None) != (cohort_size is None):
        raise ValueError("cohort_mask and cohort_size come together")
    n_layers = n_layers or N_LAYERS
    plan_cache = {} if plan_cache is None else plan_cache
    out = {gname: dict(nets) for gname, nets in client_params.items()}
    for net, n_lay in n_layers.items():
        template = {g.name: client_params[g.name][net] for g in groups}
        plan = get_federation_plan(groups, net, n_lay, template, plan_cache,
                                   chunk_size=chunk_size)
        if plan.n_rows == 0:
            continue
        aggregate = (plan.aggregate_device if chunk_size is None
                     else plan.aggregate_chunked)
        new_net = aggregate(template, weights, cluster_labels, num_clusters,
                            use_kernel=use_kernel, cohort_mask=cohort_mask)
        for g in groups:
            if g.name in new_net:
                out[g.name][net] = new_net[g.name]
    return out


def _federate_client_params_legacy(
        groups: Sequence[ProfileGroup],
        client_params: Dict[str, Dict[str, Dict[str, Any]]],
        weights: np.ndarray, cluster_labels: np.ndarray,
        n_layers: Dict[str, int], use_kernel: bool = False
        ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """The reference's quadruple loop: net x layer x cluster x member.
    For each (layer, cluster) the owners' copies are gathered and
    stacked, averaged with their weights renormalized over the cluster
    (uniform where they sum to zero) and the average is written back to
    every member. The returned trees are copies; the input is not
    modified."""
    weights = np.asarray(weights)
    cluster_labels = np.asarray(cluster_labels)
    out = {gname: {net: tree_map(torch.clone, layers)
                   for net, layers in nets.items()}
           for gname, nets in client_params.items()}
    for net, n_lay in n_layers.items():
        for layer in range(n_lay):
            owners = [(g, pos, cid) for g in groups
                      if layer in client_owned_layers(layer_pair(g.cut, net),
                                                      n_lay)
                      for pos, cid in enumerate(g.client_ids)]
            if not owners:
                continue
            for c in np.unique(cluster_labels[[cid for _, _, cid in owners]]):
                members = [(g, pos, cid) for g, pos, cid in owners
                           if cluster_labels[cid] == c]
                w = np.array([weights[cid] for _, _, cid in members])
                if w.sum() <= 0:
                    w = np.ones_like(w)
                w = w / w.sum()
                trees = [client_params[g.name][net][str(layer)]
                         for g, _, _ in members]
                stacked = tree_map(
                    lambda *xs: torch.stack([x[pos] for x, (_, pos, _) in
                                             zip(xs, members)]), *trees)
                device = next(x for _, x in tree_items(stacked)).device
                agg = weighted_average_stacked(
                    stacked, torch.as_tensor(w, dtype=torch.float32,
                                             device=device),
                    use_kernel=use_kernel)
                for g, pos, _ in members:
                    tree_map(lambda full, a: full[pos].copy_(a),
                             out[g.name][net][str(layer)], agg)
    return out


def fedavg_uniform(groups: Sequence[ProfileGroup],
                   client_params: Dict[str, Dict[str, Dict[str, Any]]],
                   sizes: np.ndarray, n_layers: Dict[str, int] = None,
                   use_kernel: bool = False, fused: bool = True,
                   plan_cache: Optional[Dict] = None,
                   chunk_size: Optional[int] = None, mesh: Any = None,
                   cohort_mask: Optional[np.ndarray] = None
                   ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Vanilla FedAvg (the warm-up rounds, paper §4.5): one global
    cluster, weights proportional to dataset size. With ``cohort_mask``
    the sizes renormalize over the cohort and non-members sit the round
    out. ``fused=False`` runs the legacy per-layer loop of
    ``federate_client_params`` (with ``use_kernel``, K1's S = 1 entry
    point once per layer and leaf)."""
    _unsupported(mesh)
    sizes = np.asarray(sizes, np.float64)
    if cohort_mask is not None:
        sizes = sizes * np.asarray(cohort_mask, bool)
    return federate_client_params(groups, client_params, sizes / sizes.sum(),
                                  np.zeros(len(sizes), np.int64),
                                  n_layers=n_layers, use_kernel=use_kernel,
                                  fused=fused, plan_cache=plan_cache,
                                  chunk_size=chunk_size,
                                  cohort_mask=cohort_mask)
