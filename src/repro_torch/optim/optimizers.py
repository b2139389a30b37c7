"""Adam and SGD over nested dicts of tensors (port of
``repro.optim.adam`` and ``repro.optim.sgd``).

``update(state, grads, params) -> (new_state, new_params)`` is applied
to the whole tree, BatchNorm running statistics included: their
gradients are zero, so they come back unchanged and the trainer puts
the forward pass's statistics back afterwards. Eps sits outside
``sqrt(vhat)`` and the bias corrections use the float32 step, as in
the reference.

Adam's step is a Python int or a 0-dim integer tensor. With a tensor
the bias corrections are computed on its device and nothing is read
back, so the update can be captured in a CUDA graph; ``update(...,
inplace=True)`` then writes the new moments, parameters and step into
the given tensors, one leaf at a time.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.nn import global_norm
from repro_torch.tree import tree_map


class AdamState(NamedTuple):
    step: Any                        # int, or a 0-dim integer tensor
    mu: Any
    nu: Any


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, grad_clip: Optional[float] = None):
    """``lr`` is a float or a callable (Python int step) -> lr. With
    ``grad_clip`` the gradients are scaled by ``min(1, clip / (gn +
    1e-9))`` of their global norm ``gn``, a device tensor (no host
    readback); ``weight_decay`` adds ``wd * p`` to the step (decoupled,
    as in the reference). Gradients and moments are float32; a
    parameter is updated in float32 and cast back to its dtype. Leaves
    are updated one at a time, so the float32 temporaries of one leaf
    are live at once, not the whole tree's."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params) -> AdamState:
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return AdamState(0, zeros, tree_map(torch.clone, zeros))

    def update(state: AdamState, grads, params, inplace: bool = False):
        scale = None
        if grad_clip is not None:
            gn = global_norm(grads)
            scale = torch.clamp(grad_clip / (gn + 1e-9), max=1.0)
        step = state.step + 1
        lr_t = lr_fn(step)
        on_device = isinstance(step, torch.Tensor)
        step_f = (step.float() if on_device
                  else torch.tensor(step, dtype=torch.float32))
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** step_f
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** step_f
        if not on_device:
            bc1, bc2 = float(bc1), float(bc2)

        def upd(p, g, m, v):
            g = g.float()
            if scale is not None:
                g = g * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return m, v, (p.float() - lr_t * delta).to(p.dtype)

        if inplace:
            def upd_(p, g, m, v):
                for buf, new in zip((m, v, p), upd(p, g, m, v)):
                    buf.copy_(new)

            tree_map(upd_, params, grads, state.mu, state.nu)
            state.step.copy_(step)
            return state, params
        out = tree_map(upd, params, grads, state.mu, state.nu)
        return (AdamState(step, tree_map(lambda t: t[0], out),
                          tree_map(lambda t: t[1], out)),
                tree_map(lambda t: t[2], out))

    return init, update


class SGDState(NamedTuple):
    step: int
    momentum: Any


def sgd(lr, momentum: float = 0.0):
    """SGD with optional heavy-ball momentum; ``lr`` is a float or a
    callable step -> lr, as in the reference."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params) -> SGDState:
        return SGDState(0, tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(state: SGDState, grads, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state.momentum, grads)
            eff = mom
        else:
            mom = state.momentum
            eff = tree_map(lambda g: g.float(), grads)
        new_params = tree_map(lambda p, g: (p.float() - lr_t * g).to(p.dtype),
                              params, eff)
        return SGDState(step, mom), new_params

    return init, update
