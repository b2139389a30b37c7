"""Trainer state between the JAX package's layout and the port's.

The reference keeps conv and transposed-conv kernels as HWIO; the port
keeps conv kernels as OIHW and transposed-conv kernels as
``F.conv_transpose2d`` weights (I, O, kh, kw) flipped in space (see
``repro_torch.models.nn``). Every other leaf keeps its layout. Both
functions work on the trainer's full state — ``{"G": {"client": ...,
"server": ...}, "D": ..., "opt_g"/"opt_d": AdamState(step, mu, nu),
"step"}`` — and on any sub-tree of it (e.g. one net's client params),
with or without the leading client axis. The Adam moments convert like
the parameters they belong to.

``state_from_numpy`` takes the reference's state as numpy arrays
(``jax.tree_util.tree_map(np.asarray, state)``); ``state_to_numpy`` gives
that form back. The GAN serving engine's state has the trainer's layout
and converts the same way.

``split_lm_from_numpy`` takes the split LM's parameters
(``{"embed", "blocks": [...], "norm_f"}``), whose layouts the port keeps.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.optimizers import AdamState


def _kind(path: Tuple[str, ...]) -> str:
    if len(path) >= 2 and path[-1] == "w" and path[-2] in ("conv", "convt"):
        return path[-2]
    return "plain"


def _lead(a: np.ndarray):
    return list(range(a.ndim - 4))


def _hwio_to_port(a: np.ndarray, kind: str) -> np.ndarray:
    d = a.ndim
    if kind == "conv":                           # -> (O, I, kh, kw)
        return a.transpose(_lead(a) + [d - 1, d - 2, d - 4, d - 3])
    if kind == "convt":                          # -> flipped (I, O, kh, kw)
        a = np.flip(a, axis=(d - 4, d - 3))
        return a.transpose(_lead(a) + [d - 2, d - 1, d - 4, d - 3])
    return a


def _port_to_hwio(a: np.ndarray, kind: str) -> np.ndarray:
    d = a.ndim
    if kind == "conv":                           # (O, I, kh, kw) ->
        return a.transpose(_lead(a) + [d - 2, d - 1, d - 3, d - 4])
    if kind == "convt":                          # flipped (I, O, kh, kw) ->
        a = a.transpose(_lead(a) + [d - 2, d - 1, d - 4, d - 3])
        return np.flip(a, axis=(d - 4, d - 3))
    return a


def _is_adam(x) -> bool:
    return all(hasattr(x, f) for f in ("step", "mu", "nu"))


def state_from_numpy(tree: Any, device="cuda", path: Tuple[str, ...] = ()
                     ) -> Any:
    """Reference-layout numpy state -> port state on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device, path + (k,))
                for k, v in tree.items()}
    if _is_adam(tree):
        return AdamState(int(tree.step), state_from_numpy(tree.mu, device),
                         state_from_numpy(tree.nu, device))
    a = np.asarray(tree)
    if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
        return int(a)                            # step counters
    a = np.ascontiguousarray(_hwio_to_port(a, _kind(path)))
    return torch.tensor(a, device=device)


def split_lm_from_numpy(params: Any, device="cuda") -> Any:
    """The reference's split-LM parameters (numpy leaves) -> the port's,
    on ``device``; the block list stays a list."""
    device = resolve_device(device)
    if isinstance(params, dict):
        return {k: split_lm_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [split_lm_from_numpy(v, device) for v in params]
    return torch.tensor(np.ascontiguousarray(params), dtype=torch.float32,
                        device=device)


def state_to_numpy(tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """Port state -> reference-layout numpy state."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, AdamState):
        return AdamState(np.int32(tree.step), state_to_numpy(tree.mu),
                         state_to_numpy(tree.nu))
    if isinstance(tree, int):
        return np.int32(tree)
    a = tree.detach().cpu().numpy()
    return np.ascontiguousarray(_port_to_hwio(a, _kind(path)))
