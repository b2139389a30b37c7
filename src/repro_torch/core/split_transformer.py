"""HuSCF applied to single-network transformers, paper §7.3 (port of
``repro.core.split_transformer``).

Two cuts per client (head / server trunk / tail): the embedding and the
first ``cut_head`` blocks, and the last ``cut_tail`` blocks with the
final norm and the tied LM head, stay on the client, so raw tokens and
predictions never leave it; the trunk in between is shared on the
server. Clients are grouped by device profile as in the GAN trainer.
A group's client parameters are stacked on a leading client axis, as in
the reference; where it ``vmap``s over that axis the port loops over the
clients (``unbind`` views), and the server trunk runs over the whole
population's batch at once, one super-block at a time under
``torch.utils.checkpoint`` while gradients are on.

``federate_split_lm`` is the clustered KLD-weighted federation of the
client copies, a plain float32 weighted sum per (cluster) or (profile,
cluster), as the reference's ``tree_weighted_sum`` (not kernel K1).

The name ``init_split_lm`` also exists in ``launch.serve_split``, for
the split serving LM, a different model; the two stay in their own
modules, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import nn
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import adam
from repro_torch.sharding.dtensor_ops import to_param_layout, whole_dim
from repro_torch.sharding.policy import maybe_shard
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LMProfileGroup:
    """Clients sharing a device profile: same (cut_head, cut_tail)."""
    name: str
    n_clients: int
    cut_head: int   # blocks on the client before the server trunk
    cut_tail: int   # blocks on the client after the server trunk


def default_groups(cfg: ArchConfig, n_weak: int = 2, n_strong: int = 2
                   ) -> List[LMProfileGroup]:
    """A representative heterogeneous population: weak devices hold one
    super-block head/tail, strong ones hold two."""
    pat = len(cfg.block_pattern)
    return [LMProfileGroup("weak", n_weak, pat, pat),
            LMProfileGroup("strong", n_strong, 2 * pat, 2 * pat)]


def init_split_lm(cfg: ArchConfig, groups: Sequence[LMProfileGroup],
                  gen: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Client stacks own embed + head/tail blocks + final norm; the
    server owns the trunk (the layers no client holds). Drawn from
    ``gen`` on its device, stored on ``device`` (default the card;
    asking for it without CUDA raises)."""
    device = resolve_device(device)
    pat = cfg.block_pattern
    n_pat = len(pat)
    trunk_layers = (cfg.n_layers - max(g.cut_head for g in groups)
                    - max(g.cut_tail for g in groups))
    n_super = trunk_layers // n_pat
    if n_super < 1:
        raise ValueError("the trunk must keep at least one super-block")
    server = {"blocks": {f"p{j}_{kind}": T.init_block(
        cfg, kind, gen, device, lead=(n_super,))
        for j, kind in enumerate(pat)}}
    clients = {}
    for g in groups:
        lead = (g.n_clients,)
        clients[g.name] = {
            "embed": {"table": nn.normal_init(
                lead + (cfg.vocab, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
                gen, device, cfg.dtype)},
            "head": {f"h{i}_{pat[i % n_pat]}": T.init_block(
                cfg, pat[i % n_pat], gen, device, lead=lead)
                for i in range(g.cut_head)},
            "tail": {f"t{i}_{pat[i % n_pat]}": T.init_block(
                cfg, pat[i % n_pat], gen, device, lead=lead)
                for i in range(g.cut_tail)},
            "final_norm": T._norm_init(cfg, device, lead)}
    return {"server": server, "clients": clients}


def split_lm_forward(cfg: ArchConfig, params: Dict[str, Any],
                     groups: Sequence[LMProfileGroup],
                     tokens: Dict[str, torch.Tensor], rows=None
                     ) -> Dict[str, torch.Tensor]:
    """tokens: {group: [K_g, b, S]} -> float32 logits {group:
    [K_g, b, S, V]}. ``rows``, a layout of the client stacks over a
    mesh's ranks (``launch.dryrun_paper.RankRows``: ``local`` takes this
    rank's clients of a tree of stacks, ``to_mesh`` makes their rows its
    block of a batch over the whole mesh, ``from_mesh`` is the inverse):
    this rank's clients' rows and logits."""
    pat = cfg.block_pattern
    n_pat = len(pat)
    S = next(iter(tokens.values())).shape[-1]
    device = next(iter(tokens.values())).device
    positions = torch.arange(S, device=device)
    clients = params["clients"]
    if rows is not None:
        clients, tokens = rows.local(clients), rows.local(tokens)

    def blocks(cp, prefix, n, x):
        for i in range(n):
            kind = pat[i % n_pat]
            x = T.block_seq(cfg, kind, cp[f"{prefix}{i}_{kind}"], x,
                            positions)[0]
        return x

    def copies(g):
        return T.unstack(clients[g.name], tokens[g.name].shape[0])

    acts = []
    for g in groups:
        for cp, toks in zip(copies(g),
                            whole_dim(tokens[g.name], 0).unbind(0)):
            x = T._embed(cfg, cp, toks, None)
            acts.append(blocks(cp["head"], "h", g.cut_head, x))
    x = torch.cat(acts, 0)
    x = maybe_shard(rows.to_mesh(x) if rows is not None else x, "resid")

    def trunk(x, slice_p):
        for j, kind in enumerate(pat):
            x = T.block_seq(cfg, kind, slice_p[f"p{j}_{kind}"], x,
                            positions)[0]
        return x

    n_super = _first_leaf(params["server"]["blocks"]).shape[0]
    for slice_p in T.unstack(params["server"]["blocks"], n_super):
        x = T._remat(lambda x_, sp=slice_p: trunk(x_, sp), x)
    if rows is not None:
        x = whole_dim(rows.from_mesh(x), 0)

    out, start = {}, 0
    for g in groups:
        logits = []
        for cp in copies(g):
            b = tokens[g.name].shape[1]
            h = blocks(cp["tail"], "t", g.cut_tail, x[start:start + b])
            start += b
            h = maybe_shard(T._norm_apply(cfg, cp["final_norm"], h),
                            "resid_inner")
            logits.append(nn.embedding_attend(cp["embed"], h))
        out[g.name] = torch.stack(logits)
    return out


def split_lm_loss(cfg: ArchConfig, params: Dict[str, Any],
                  groups: Sequence[LMProfileGroup],
                  batch: Dict[str, Dict[str, torch.Tensor]], rows=None
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(the clients' mean NLL, {}). ``rows`` as in ``split_lm_forward``;
    it also sums the loss over the ranks (``sum_over_ranks``)."""
    logits = split_lm_forward(cfg, params, groups, batch["tokens"], rows)
    labels = (batch["labels"] if rows is None
              else rows.local(batch["labels"]))
    total, count = 0.0, 0
    for g in groups:
        logp = torch.log_softmax(logits[g.name].float(), -1)
        nll = T.token_nll(logp, labels[g.name].long())
        # this rank's clients (all of them without a mesh)
        total = total + nll.mean() * logp.shape[0]
        count += g.n_clients
    if rows is not None:
        total = rows.sum_over_ranks(total)
    return total / count, {}


def make_split_train_step(cfg: ArchConfig, groups: Sequence[LMProfileGroup],
                          lr: float = 1e-4, rows=None):
    """Returns (train_step, opt_init) over the split-population state:
    Adam with global-norm clipping at 1.0, on ``split_lm_loss``."""
    opt_init, opt_update = adam(lr, grad_clip=1.0)

    def train_step(params, opt_state, batch):
        loss, _, grads = T.value_and_grad(
            lambda p: split_lm_loss(cfg, p, groups, batch, rows), params)
        opt_state, params = opt_update(
            opt_state, to_param_layout(grads, params), params)
        return params, opt_state, {"loss": loss}

    return train_step, opt_init


def federate_split_lm(params: Dict[str, Any],
                      groups: Sequence[LMProfileGroup],
                      weights: np.ndarray, labels: np.ndarray):
    """Clustered KLD-weighted federation of the client segments: the
    embedding + final norm (held by every client) aggregate cluster-wise;
    head/tail blocks aggregate over the clients of one profile in one
    cluster (layer-wise ownership, as in the GAN trainer). Cluster
    weights are normalised in float64 and summed in float32."""
    offsets, offset = {}, 0
    for g in groups:
        offsets[g.name] = offset
        offset += g.n_clients
    new_clients = {g.name: {k: tree_map(torch.clone, v) for k, v in
                            params["clients"][g.name].items()}
                   for g in groups}
    for c in np.unique(labels):
        members = [(g, pos, weights[offsets[g.name] + pos])
                   for g in groups for pos in range(g.n_clients)
                   if labels[offsets[g.name] + pos] == c]
        w = np.array([m[2] for m in members], np.float64)
        w = (w / w.sum() if w.sum() > 0
             else np.full(len(members), 1 / len(members)))
        for key in ("embed", "final_norm"):
            stacked = tree_map(lambda *xs: torch.stack(xs), *[
                tree_map(lambda x, pos=pos: x[pos],
                         params["clients"][g.name][key])
                for g, pos, _ in members])
            agg = nn.tree_weighted_sum(stacked, torch.tensor(
                w, dtype=torch.float32, device=_first_leaf(stacked).device))
            for g, pos, _ in members:
                tree_map(lambda full, a, pos=pos: full[pos].copy_(a),
                         new_clients[g.name][key], agg)
        for g in groups:
            sel = [pos for gg, pos, _ in members if gg is g]
            if len(sel) < 2:
                continue
            wsel = np.array([weights[offsets[g.name] + p] for p in sel])
            wsel = wsel / wsel.sum()
            idx = torch.tensor(
                sel, device=_first_leaf(params["clients"][g.name]).device)
            for key in ("head", "tail"):
                sub = tree_map(lambda x: x[idx],
                               params["clients"][g.name][key])
                agg = nn.tree_weighted_sum(sub, torch.tensor(
                    wsel, dtype=torch.float32, device=idx.device))
                tree_map(lambda full, a: full.index_copy_(
                    0, idx, a[None].expand((len(sel),) + a.shape)
                    .to(full.dtype)), new_clients[g.name][key], agg)
    return {"server": params["server"], "clients": new_clients}


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree
