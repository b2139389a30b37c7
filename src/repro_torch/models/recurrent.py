"""Recurrent blocks (port of ``repro.models.recurrent``): RG-LRU
(RecurrentGemma), mLSTM and sLSTM (xLSTM), each as a sequence form for
training and prefill (``*_seq``) and a one-step form for decode
(``*_step``) with O(1) state.

The reference runs RG-LRU's linear recurrence as ``lax.associative_scan``
and mLSTM/sLSTM as ``lax.scan`` over time. Here RG-LRU is a log-depth
Hillis-Steele scan (``ceil(log2 S)`` rounds of elementwise products and
sums, in float32): the same recurrence, summed in another order, so it
agrees with the reference to float32 rounding of the products of decays,
not bit for bit. mLSTM and sLSTM loop over time in Python: one cell
update per step, 16-18 tensor ops each (the products, gates and
normaliser), so a layer's forward launches ~17 S kernels for its
recurrence; a fused chunkwise kernel is later work. On DTensors (a mesh
run) the loops, and the one-step cells of decode, run on each rank's
own batch rows and heads or hidden units (``dtensor_ops.local_recurrence``,
``dtensor_ops.local_step``); the projections into them stay DTensor
operations, and the mLSTM's head-wise output projection and the sLSTM's
output gate contract each rank's shards (``dtensor_ops.heads_out``,
``dtensor_ops.rows_in``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.sharding.dtensor_ops import heads_out, \
    local_recurrence, local_step, pad, rows_in

RG_LRU_C = 8.0


def _normal(lead, shape, std, gen, device, dtype):
    return nn.normal_init(tuple(lead) + tuple(shape), std, gen, device, dtype)


# ---------------------------------------------------------------------------
# RG-LRU — arXiv:2402.19427
#   h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
#   a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))
# ---------------------------------------------------------------------------

def rglru_init(d_model: int, d_rnn: int, gen, device, dtype=torch.float32,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """As in the reference, Griffin's width-4 temporal conv before the
    LRU is left out; ``lambda`` (float32) puts the decay a^(1/c) in
    [0.9, 0.999)."""
    std = 1.0 / math.sqrt(d_model)
    std_r = 1.0 / math.sqrt(d_rnn)
    u = torch.rand(tuple(lead) + (d_rnn,), generator=gen, device=gen.device)
    u = 0.9 ** 2 + u * (0.999 ** 2 - 0.9 ** 2)
    lam = torch.log(torch.expm1(-torch.log(u) / RG_LRU_C))
    return {
        "w_in": _normal(lead, (d_model, d_rnn), std, gen, device, dtype),
        "w_gate_x": _normal(lead, (d_model, d_rnn), std, gen, device, dtype),
        "lambda": lam.to(device=device, dtype=torch.float32),
        "w_rec_gate": _normal(lead, (d_rnn, d_rnn), std_r, gen, device,
                              dtype),
        "w_in_gate": _normal(lead, (d_rnn, d_rnn), std_r, gen, device,
                             dtype),
        "w_out": _normal(lead, (d_rnn, d_model), std_r, gen, device, dtype),
    }


def _rglru_gates(p, u: torch.Tensor):
    """u [.., S, d_rnn] -> (a, gated input), float32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_rec_gate"].float())
    i = torch.sigmoid(uf @ p["w_in_gate"].float())
    log_a = -RG_LRU_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * uf)
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, along axis 1, as a
    log-depth inclusive scan of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)."""
    S = a.shape[1]
    off = 1
    while off < S:
        a_prev = pad(a[:, :-off], (0, 0, off, 0), value=1.0)
        b_prev = pad(b[:, :-off], (0, 0, off, 0), value=0.0)
        b = b_prev * a + b
        a = a_prev * a
        off *= 2
    return b


def rglru_seq(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], final state [B, d_rnn] float32)."""
    u = (x @ p["w_in"]).to(x.dtype)
    a, gated = _rglru_gates(p, u)
    h = linear_scan(a, gated)
    gate_x = torch.sigmoid(x.float() @ p["w_gate_x"].float())
    out = ((h * gate_x).to(x.dtype) @ p["w_out"]).to(x.dtype)
    return out, h[:, -1].float()


def rglru_step(p, x: torch.Tensor, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, 1, D]; state [B, d_rnn] -> (out [B, 1, D], new state)."""
    u = (x @ p["w_in"]).to(x.dtype)
    a, gated = _rglru_gates(p, u)
    h = a[:, 0] * state + gated[:, 0]
    gate_x = torch.sigmoid(x.float() @ p["w_gate_x"].float())
    out = (h * gate_x[:, 0]).to(x.dtype) @ p["w_out"]
    return out[:, None].to(x.dtype), h


# ---------------------------------------------------------------------------
# mLSTM — arXiv:2405.04517
#   C_t = f_t C_{t-1} + i_t (v_t k_t^T);  n_t = f_t n_{t-1} + i_t k_t
#   h_t = o_t * (C_t q_t) / max(|n_t^T q_t|, 1)
# ---------------------------------------------------------------------------

def mlstm_init(d_model: int, n_heads: int, head_dim: int, gen, device,
               dtype=torch.float32, lead: Tuple[int, ...] = ()
               ) -> Dict[str, torch.Tensor]:
    std = 1.0 / math.sqrt(d_model)
    return {
        "wq": _normal(lead, (d_model, n_heads, head_dim), std, gen, device,
                      dtype),
        "wk": _normal(lead, (d_model, n_heads, head_dim), std, gen, device,
                      dtype),
        "wv": _normal(lead, (d_model, n_heads, head_dim), std, gen, device,
                      dtype),
        "w_if": _normal(lead, (d_model, n_heads, 2), std, gen, device, dtype),
        "w_o": _normal(lead, (d_model, n_heads, head_dim), std, gen, device,
                       dtype),
        "wo": _normal(lead, (n_heads, head_dim, d_model),
                      1.0 / math.sqrt(n_heads * head_dim), gen, device,
                      dtype),
    }


def _mlstm_qkvg(p, x):
    xf = x.float()
    q = torch.einsum("bsd,dnh->bsnh", xf, p["wq"].float())
    k = torch.einsum("bsd,dnh->bsnh", xf, p["wk"].float())
    v = torch.einsum("bsd,dnh->bsnh", xf, p["wv"].float())
    if_ = torch.einsum("bsd,dnt->bsnt", xf, p["w_if"].float())
    i_gate = torch.exp(torch.clamp(if_[..., 0], -10.0, 10.0))
    f_gate = torch.sigmoid(if_[..., 1] + 1.0)
    o_gate = torch.sigmoid(torch.einsum("bsd,dnh->bsnh", xf,
                                        p["w_o"].float()))
    k = k / math.sqrt(q.shape[-1])
    return q, k, v, i_gate, f_gate, o_gate


def step(cell, state, xt):
    """One token of a recurrence: ``cell(*state, *xt)``, the new state
    and the output. The loops take each token's inputs from one
    ``unbind`` of the sequence (its backward one ``stack``, where a
    slice per step would scatter each step's gradient into a zero
    tensor of the whole sequence). Every step of a loop has the same
    shapes, which the dry run's count uses (``launch.dryrun``)."""
    return cell(*state, *xt)


def _mlstm_cell(C, n, q, k, v, it, ft, ot):
    # the outer product as a product over a dim of one, as the
    # reference's dot_general without contracting dims counts it
    kv = torch.matmul(k[..., :, None], v[..., None, :])
    C = ft[..., None, None] * C + it[..., None, None] * kv
    n = ft[..., None] * n + it[..., None] * k
    num = torch.einsum("bnhg,bnh->bng", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bnh,bnh->bn", n, q)), min=1.0)
    return C, n, ot * num / den[..., None]


def mlstm_seq(p, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x [B,S,D] -> (out [B,S,D], state {C [B,N,hd,hd], n [B,N,hd]})."""
    hs, C, n = _mlstm_scan(*_mlstm_qkvg(p, x))              # [B,S,N,hd]
    out = heads_out(hs.to(x.dtype), p["wo"]).to(x.dtype)
    return out, {"C": C, "n": n}


@local_recurrence((2, 1, 1))
def _mlstm_scan(q, k, v, i_g, f_g, o_g):
    """The mLSTM over time from a zero state: (h [B,S,N,hd], C, n)."""
    B, _, N, hd = q.shape
    C = torch.zeros((B, N, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, N, hd), dtype=torch.float32, device=q.device)
    hs = []
    for xt in zip(*(x.unbind(1) for x in (q, k, v, i_g, f_g, o_g))):
        C, n, h = step(_mlstm_cell, (C, n), xt)
        hs.append(h)
    return torch.stack(hs, 1), C, n


def mlstm_step(p, x: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x [B,1,D] -> (out [B,1,D], new state)."""
    C, n, h = local_step(_mlstm_cell, (state["C"], state["n"]),
                         _mlstm_qkvg(p, x))                  # h [B,1,N,hd]
    out = heads_out(h.to(x.dtype), p["wo"]).to(x.dtype)
    return out, {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, exponential gating) — arXiv:2405.04517
# ---------------------------------------------------------------------------

def slstm_init(d_model: int, d_hidden: int, gen, device, dtype=torch.float32,
               lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    std = 1.0 / math.sqrt(d_model)
    p = {name: _normal(lead, (d_model, d_hidden), std, gen, device, dtype)
         for name in ("w_z", "w_i", "w_f", "w_o")}
    p["w_out"] = _normal(lead, (d_hidden, d_model), 1.0 / math.sqrt(d_hidden),
                         gen, device, dtype)
    return p


def _slstm_pre(p, x):
    xf = x.float()
    z = torch.tanh(xf @ p["w_z"].float())
    i = torch.clamp(xf @ p["w_i"].float(), -10, 10)
    f = torch.clamp(xf @ p["w_f"].float(), -10, 10)
    # w_o is split along d_model where the others split d_hidden: its
    # partial sums go onto z's layout (dtensor_ops.rows_in)
    o = torch.sigmoid(rows_in(xf, p["w_o"].float(), z))
    return z, i, f, o


def _slstm_cell(c, n, m, z_t, i_t, f_t, o_t):
    """Stabilised exponential-gating cell update (eq. 15-19 of xLSTM)."""
    log_f = F.logsigmoid(f_t)
    new_m = torch.maximum(log_f + m, i_t)
    i_s = torch.exp(i_t - new_m)
    f_s = torch.exp(log_f + m - new_m)
    c = f_s * c + i_s * z_t
    n = f_s * n + i_s
    h = o_t * c / torch.clamp(n, min=1e-6)
    return c, n, new_m, h


def slstm_seq(p, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x [B,S,D] -> (out [B,S,D], state {c, n, m} [B, H]); ``m`` starts
    at -1e30 as in the reference."""
    hs, c, n, m = _slstm_scan(*_slstm_pre(p, x))
    out = (hs.to(x.dtype) @ p["w_out"]).to(x.dtype)
    return out, {"c": c, "n": n, "m": m}


@local_recurrence((2, 1, 1, 1))
def _slstm_scan(z, i, f, o):
    """The sLSTM over time from its initial state: (h [B,S,H], c, n,
    m)."""
    B, _, H = z.shape
    c = torch.zeros((B, H), dtype=torch.float32, device=z.device)
    n = torch.zeros((B, H), dtype=torch.float32, device=z.device)
    m = torch.full((B, H), -1e30, dtype=torch.float32, device=z.device)
    hs = []
    for xt in zip(*(x.unbind(1) for x in (z, i, f, o))):
        c, n, m, h = step(_slstm_cell, (c, n, m), xt)
        hs.append(h)
    return torch.stack(hs, 1), c, n, m


def slstm_step(p, x: torch.Tensor, state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x [B,1,D] -> (out [B,1,D], new state)."""
    c, n, m, h = local_step(_slstm_cell, (state["c"], state["n"],
                                          state["m"]), _slstm_pre(p, x))
    out = (h.to(x.dtype) @ p["w_out"]).to(x.dtype)       # h [B,1,H]
    return out, {"c": c, "n": n, "m": m}
