"""Mixture-of-Experts FFN (port of ``repro.models.moe``): GShard-style
grouped top-k dispatch and combine with capacity limits, the switch
load-balance loss and the router z-loss.

Each batch row is a routing group with capacity
``C = max(1, int(cf * S * k / E))``; dispatch and combine are one-hot
``[B, S, E, C]`` tensors and the experts run as einsums over them, with
float32 results as the reference asks (``nn.mm_f32``'s rule).

Top-k takes the highest router probabilities with ties to the lowest
expert index, as ``jax.lax.top_k`` does: a stable descending sort keeps
equal probabilities in index order (``torch.topk`` promises no order on
ties), so capacity overflow drops the same tokens as the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn


def moe_init(d_model: int, d_ff: int, n_experts: int, gen, device, *,
             mlp_variant: str = "swiglu", dtype=torch.float32,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Router in float32, experts ``wi/wg [E, d, f]``, ``wo [E, f, d]``
    in ``dtype``; ``lead`` prepends stacking axes."""
    std = 1.0 / math.sqrt(d_model)
    p = {
        "router": nn.normal_init(lead + (d_model, n_experts), std, gen,
                                 device, torch.float32),
        "wi": nn.normal_init(lead + (n_experts, d_model, d_ff), std, gen,
                             device, dtype),
        "wo": nn.normal_init(lead + (n_experts, d_ff, d_model),
                             1.0 / math.sqrt(d_ff), gen, device, dtype),
    }
    if mlp_variant in ("swiglu", "geglu"):
        p["wg"] = nn.normal_init(lead + (n_experts, d_model, d_ff), std, gen,
                                 device, dtype)
    return p


def top_k_stable(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis; equal
    values come in index order, as ``jax.lax.top_k`` gives them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, mlp_variant: str = "swiglu"
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (out [B, S, D], aux losses and expert counts)."""
    B, S, D = x.shape
    E = p["router"].shape[1]

    logits = torch.einsum("bsd,de->bse", x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)                  # [B, S, E]

    gate_vals, gate_idx = top_k_stable(probs, top_k)       # [B, S, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    capacity = max(1, int(capacity_factor * S * top_k / E))

    combine = torch.zeros((B, S, E, capacity), dtype=torch.float32,
                          device=x.device)
    dispatch = torch.zeros((B, S, E, capacity), dtype=torch.bool,
                           device=x.device)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    for slot in range(top_k):
        e = gate_idx[..., slot]                            # [B, S]
        onehot = F.one_hot(e, E)                           # [B, S, E]
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        pos_e = torch.gather(pos, 2, e[..., None])[..., 0]  # [B, S]
        keep = pos_e < capacity
        counts = counts + onehot.sum(1)
        # one_hot of a position past capacity is all zeros, as in JAX
        pos_oh = (pos_e[..., None] == torch.arange(
            capacity, device=x.device)).float()            # [B, S, C]
        contrib = onehot.float()[..., None] * pos_oh[..., None, :]
        contrib = contrib * keep[..., None, None]
        dispatch = dispatch | (contrib > 0)
        combine = combine + contrib * gate_vals[..., slot][..., None, None]

    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    hi = torch.einsum("becd,edf->becf", xe.float(), p["wi"].float())
    if mlp_variant in ("swiglu", "geglu"):
        hg = torch.einsum("becd,edf->becf", xe.float(), p["wg"].float())
        act = (F.silu(hg) if mlp_variant == "swiglu" else nn.gelu(hg)) * hi
    else:
        act = nn.gelu(hi)
    ye = torch.einsum("becf,efd->becd", act.to(x.dtype).float(),
                      p["wo"].float())
    out = torch.einsum("bsec,becd->bsd", combine, ye).to(x.dtype)

    top1 = gate_idx[..., 0].reshape(-1)
    frac = F.one_hot(top1, E).float().mean(0)
    lb = E * torch.sum(frac * probs.reshape(-1, E).mean(0))
    z = torch.mean(torch.logsumexp(logits, -1) ** 2)
    aux = {"load_balance": lb, "router_z": z,
           "expert_counts": counts.sum(0).float()}
    return out, aux
