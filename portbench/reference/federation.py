"""The paper's federation round (§4.5, Eq. 13-16), in plain PyTorch and
float64, for judging a clustered round the program ran.

* Eq. 13: ``P_k = softmax(alpha_k)``, alpha_k client k's middle
  activation (the EMA the program clusters);
* Eq. 14: ``P_j,k``, the mean of P over the other members of k's
  cluster, and ``KLD_k = KL(P_k || P_j,k)`` (0 for a cluster of one);
* Eq. 15: within each cluster, over the clients of this round's cohort,
  ``s_k = softmax(log n_k - beta KLD_k)``; 0 outside the cohort;
* Eq. 16: for every layer a client owns and every cluster, the members
  of the cohort that own the layer take the average of their copies
  weighted by their ``s_k`` renormalized over them (uniform where those
  sum to 0); every other copy keeps its values.

The labels are the reference's own (``reference.kmeans``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference.cgan import tf32_round


def kld_weights(acts: torch.Tensor, sizes: torch.Tensor,
                labels: torch.Tensor, cohort: torch.Tensor, beta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [K], KLDs [K]) of Eq. 13-15, in float64."""
    P = torch.softmax(acts.double(), dim=-1)
    lab = labels.long()
    K = P.shape[0]
    klds = torch.zeros(K, dtype=torch.float64, device=P.device)
    for c in torch.unique(lab):
        idx = torch.nonzero(lab == c).flatten()
        if idx.numel() < 2:
            continue
        Pc = P[idx]
        loo = (Pc.sum(0, keepdim=True) - Pc) / (idx.numel() - 1)
        p = Pc.clamp_min(1e-12)
        q = loo.clamp_min(1e-12)
        klds[idx] = (p * (p.log() - q.log())).sum(-1)
    logits = sizes.double().clamp_min(1e-300).log() - beta * klds
    w = torch.zeros(K, dtype=torch.float64, device=P.device)
    for c in torch.unique(lab[cohort]):
        idx = torch.nonzero((lab == c) & cohort).flatten()
        w[idx] = torch.softmax(logits[idx], 0)
    return w, klds


def aggregate(before: Dict[Tuple[int, str], torch.Tensor],
              owners: Dict[int, torch.Tensor], labels: torch.Tensor,
              cohort: torch.Tensor, w: torch.Tensor,
              tf32: bool = False, write_all: bool = False) -> Dict[Tuple[int, str], torch.Tensor]:
    """Eq. 16 over one net's client leaves ``{(layer, path): [n_owners,
    ...]}`` (rows in the order of ``owners[layer]``, client ids), each
    average a product of the weights row with the members' copies: in
    float64, or with ``tf32`` (the control) in float32 with both
    operands rounded to TF32. ``write_all`` writes each average into
    every owner in the cluster, in the cohort or not (a planted fault)."""
    def cast(x):
        return tf32_round(x.float()) if tf32 else x.double()

    out = {}
    for (l, path), theta in before.items():
        ids = owners[l]
        lab = labels.long()[ids]
        part = cohort[ids]
        new = theta.clone()
        flat = theta.reshape(theta.shape[0], -1)
        for c in torch.unique(lab[part]):
            sel = torch.nonzero((lab == c) & part).flatten()
            ws = w[ids[sel]].double()
            ws = ws / ws.sum() if ws.sum() > 0 else torch.full_like(
                ws, 1.0 / sel.numel())
            avg = torch.matmul(cast(ws[None]), cast(flat[sel]))[0]
            dst = torch.nonzero(lab == c).flatten() if write_all else sel
            new[dst] = avg.to(theta.dtype).reshape(theta.shape[1:])
        out[(l, path)] = new
    return out
