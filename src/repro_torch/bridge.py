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

The baselines' state converts the same way: their per-client Adam
(the reference's vmapped ``opt_init``) has a ``[K]`` step of equal
entries, which becomes the port's one int. MD-GAN's and Fed-Split-GAN's
single server networks have no client axis in the reference and a K = 1
axis in the port (``single_from_numpy`` / ``single_to_numpy``). The
evaluation CNN's conv kernels sit at ``c1``/``c2``, not under a
``conv`` key, so they have their own pair (``classifier_from_numpy`` /
``classifier_to_numpy``).

``split_lm_from_numpy`` takes the split LM's parameters
(``{"embed", "blocks": [...], "norm_f"}``), whose layouts the port keeps.

``lm_from_numpy`` / ``lm_to_numpy`` carry the monolithic LM's
parameters and caches (``repro.models.transformer``), and
``split_transformer_from_numpy`` the split transformer's
(``repro.core.split_transformer``): the port keeps their trees and
layouts, so every leaf is a plain copy. A bfloat16 array (an
``ml_dtypes`` array, which only JAX's side has) crosses as its 16-bit
words and is viewed as ``torch.bfloat16``; a 0-dim integer (a cache's
``length``) becomes a Python int.
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


def _step_from_numpy(step) -> int:
    """Adam's step: a scalar, or the ``[K]`` vector of a vmapped
    optimiser (the baselines' per-client Adam), whose entries are equal
    because every client steps together."""
    a = np.asarray(step).reshape(-1)
    if a.size == 0 or (a != a[0]).any():
        raise ValueError(f"per-client Adam steps differ: {a}; the port "
                         "keeps one step for the stacked tree")
    return int(a[0])


def state_from_numpy(tree: Any, device="cuda", path: Tuple[str, ...] = ()
                     ) -> Any:
    """Reference-layout numpy state -> port state on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device, path + (k,))
                for k, v in tree.items()}
    if _is_adam(tree):
        return AdamState(_step_from_numpy(tree.step),
                         state_from_numpy(tree.mu, device),
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
        return AdamState(np.int32(int(tree.step)), state_to_numpy(tree.mu),
                         state_to_numpy(tree.nu))
    if isinstance(tree, int):
        return np.int32(tree)
    return leaf_to_numpy(path, tree)


def leaf_to_numpy(path: Tuple[str, ...], x: torch.Tensor) -> np.ndarray:
    """One parameter leaf of a GAN tree at ``path`` -> the reference's
    layout, as a numpy copy: the trainer's fused epochs write into its
    tensors in place, so a view would change under the caller."""
    a = x.detach().to("cpu", copy=True).numpy()
    return np.ascontiguousarray(_port_to_hwio(a, _kind(path)))


def _map_arrays(fn, tree: Any) -> Any:
    """``fn`` on every array leaf of a dict / AdamState tree; Adam's step
    passes through."""
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if _is_adam(tree):
        return type(tree)(tree.step, _map_arrays(fn, tree.mu),
                          _map_arrays(fn, tree.nu))
    return fn(tree)


def single_from_numpy(tree: Any, device="cuda") -> Any:
    """One network (or its Adam state) without a client axis, as the
    reference keeps MD-GAN's and Fed-Split-GAN's server G and D tail ->
    the port's K = 1 stacked form on ``device``."""
    return state_from_numpy(_map_arrays(lambda a: np.asarray(a)[None], tree),
                            device)


def single_to_numpy(tree: Any) -> Any:
    """Inverse of ``single_from_numpy``: drops the K = 1 axis."""
    return _map_arrays(lambda a: a[0], state_to_numpy(tree))


def _classifier_kind(name: str, leaf: str) -> str:
    return "conv" if name in ("c1", "c2") and leaf == "w" else "plain"


def classifier_from_numpy(params: Any, device="cuda") -> Any:
    """The evaluation CNN's reference parameters (``{"c1", "c2", "fc1",
    "fc2"}``, numpy leaves) -> the port's on ``device``: the conv kernels
    ``c1``/``c2`` go from HWIO to OIHW, the dense layers keep their
    ``[in, out]`` layout."""
    device = resolve_device(device)
    return {name: {leaf: torch.tensor(np.ascontiguousarray(_hwio_to_port(
        np.asarray(a), _classifier_kind(name, leaf))), device=device)
        for leaf, a in layer.items()} for name, layer in params.items()}


def classifier_to_numpy(params: Any) -> Any:
    """Inverse of ``classifier_from_numpy``."""
    return {name: {leaf: np.ascontiguousarray(_port_to_hwio(
        x.detach().cpu().numpy(), _classifier_kind(name, leaf)))
        for leaf, x in layer.items()} for name, layer in params.items()}


def _lm_leaf(a, device) -> Any:
    a = np.asarray(a)
    if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
        return int(a)
    if a.dtype.name == "bfloat16":
        words = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).to(device)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def lm_from_numpy(tree: Any, device="cuda") -> Any:
    """The reference's LM parameters or cache (numpy leaves) -> the
    port's, on ``device``."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_from_numpy(v, device) for k, v in tree.items()}
    return _lm_leaf(tree, device)


def lm_to_numpy(tree: Any) -> Any:
    """Inverse of ``lm_from_numpy``: numpy leaves (a bfloat16 leaf as an
    ``ml_dtypes.bfloat16`` array, for JAX's side), ints as ``np.int32``."""
    if isinstance(tree, dict):
        return {k: lm_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, int):
        return np.int32(tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def split_transformer_from_numpy(params: Any, device="cuda") -> Any:
    """The reference's split-transformer parameters (``{"server":
    {"blocks"}, "clients": {group: {"embed", "head", "tail",
    "final_norm"}}}``, client leaves stacked on the client axis) -> the
    port's on ``device``; the same tree, leaf by leaf."""
    return lm_from_numpy(params, device)
