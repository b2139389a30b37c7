"""Adam over nested dicts of tensors (port of ``repro.optim.adam``).

``update(state, grads, params) -> (new_state, new_params)`` is applied
to the whole tree, BatchNorm running statistics included: their
gradients are zero, so they come back unchanged and the trainer puts
the forward pass's statistics back afterwards. Eps sits outside
``sqrt(vhat)`` and the bias corrections use the float32 step, as in
the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_map


class AdamState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return AdamState(0, zeros, tree_map(torch.clone, zeros))

    def update(state: AdamState, grads, params):
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        step_f = torch.tensor(step, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step_f)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step_f)

        def upd(p, m, v):
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return p - lr * delta

        new_params = tree_map(upd, params, mu, nu)
        return AdamState(step, mu, nu), new_params

    return init, update
