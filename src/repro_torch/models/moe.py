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

On DTensors (a mesh run) the routing and the aux losses are DTensor
operations on the batch-split tokens, and the expert FFN (``experts``:
``route``'s dispatch and combine, ``expert_ffn``'s einsums) runs on
each rank's own batch rows and its own experts or ``d_ff`` slice
(``sharding.dtensor_ops.local_experts``), the top-k on each rank's own
rows (``local_rows``). Their gradients are laid out by name where the
router's and the aux losses' meet (``dtensor_ops.grad_as_resid``,
``keep_grad_layout``, ``whole``), not by a torch version's DTensor
rules.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.sharding.dtensor_ops import grad_as_resid, \
    keep_grad_layout, local_experts, local_rows, whole


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


@local_rows
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

    logits = torch.einsum("bsd,de->bse", grad_as_resid(x).float(),
                          p["router"])
    probs = torch.softmax(logits, dim=-1)                  # [B, S, E]

    gate_vals, gate_idx = top_k_stable(probs, top_k)       # [B, S, k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # the aux losses before the experts: a recomputed (checkpointed)
    # layer then stops at the combine product's saved inputs, as the
    # reference's remat recomputes only what its backward reads
    top1 = gate_idx[..., 0].reshape(-1)
    # the batch means whole on every rank of a mesh (``z`` where the
    # loss needs it: ``transformer._moe_aux_loss``)
    frac = whole(F.one_hot(top1, E).float().mean(0))
    p_mean = whole(keep_grad_layout(probs).reshape(-1, E).mean(0))
    lb = E * torch.sum(frac * p_mean)
    z = torch.mean(torch.logsumexp(keep_grad_layout(logits), -1) ** 2)
    # every slot's choice, kept or dropped, as the reference counts them
    counts = (gate_idx[..., None] == torch.arange(E, device=x.device))
    aux = {"load_balance": lb, "router_z": z,
           "expert_counts": counts.sum((0, 1, 2)).float()}

    capacity = max(1, int(capacity_factor * S * top_k / E))
    out = experts(x, gate_vals, gate_idx, p["wi"], p.get("wg"), p["wo"],
                  capacity=capacity, mlp_variant=mlp_variant)
    return out.to(x.dtype), aux


@local_experts
def experts(x: torch.Tensor, gate_vals: torch.Tensor, gate_idx: torch.Tensor,
            wi: torch.Tensor, wg: Optional[torch.Tensor], wo: torch.Tensor, *,
            capacity: int, mlp_variant: str = "swiglu", expert0: int = 0
            ) -> torch.Tensor:
    """The FFN of experts ``[expert0, expert0 + wi.shape[0])`` on the
    tokens routed to them, combined with their gates: float32
    ``[B, S, D]``, the sum over all experts when they are all here.
    ``gate_idx``/``gate_vals`` ``[B, S, k]`` are each token's experts
    and gates, in slot order."""
    dispatch, combine = route(gate_idx, gate_vals,
                              expert0 + torch.arange(wi.shape[0],
                                                     device=x.device),
                              capacity)
    return expert_ffn(x, dispatch, combine, wi, wg, wo, mlp_variant)


def route(gate_idx: torch.Tensor, gate_vals: torch.Tensor,
          experts: torch.Tensor, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch (bool) and combine (float32) ``[B, S, E', C]`` of the
    experts ``experts`` (E' of them): slot by slot, a token takes the
    next free place of its expert in its row, and is dropped past
    ``capacity``. An expert's places depend on its own tokens only, so
    a subset of the experts gets exactly its slice of the whole."""
    B, S, _ = gate_idx.shape
    places = torch.arange(capacity, device=gate_idx.device)
    combine = torch.zeros((B, S, experts.shape[0], capacity),
                          dtype=torch.float32, device=gate_idx.device)
    dispatch = torch.zeros(combine.shape, dtype=torch.bool,
                           device=gate_idx.device)
    counts = torch.zeros((B, experts.shape[0]), dtype=torch.int64,
                         device=gate_idx.device)
    for slot in range(gate_idx.shape[-1]):
        onehot = (gate_idx[..., slot, None] == experts).long()  # [B, S, E']
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(1)
        # a place past capacity matches none, as JAX's one_hot of it
        contrib = onehot.float()[..., None] * (pos[..., None] == places)
        dispatch = dispatch | (contrib > 0)
        combine = combine + contrib * gate_vals[..., slot][..., None, None]
    return dispatch, combine


def expert_ffn(x: torch.Tensor, dispatch: torch.Tensor, combine: torch.Tensor,
               wi: torch.Tensor, wg: Optional[torch.Tensor],
               wo: torch.Tensor, mlp_variant: str) -> torch.Tensor:
    """The experts' einsums: tokens into their places, the FFN per
    expert with float32 results, and back out weighted by ``combine``."""
    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    hi = torch.einsum("becd,edf->becf", xe.float(), wi.float())
    if mlp_variant in ("swiglu", "geglu"):
        hg = torch.einsum("becd,edf->becf", xe.float(), wg.float())
        act = (F.silu(hg) if mlp_variant == "swiglu" else nn.gelu(hg)) * hi
    else:
        act = nn.gelu(hi)
    ye = torch.einsum("becf,efd->becd", act.to(x.dtype).float(), wo.float())
    return torch.einsum("bsec,becd->bsd", combine, ye)
