"""The initial weights of a run, made from ``--seed`` on the device in
one call per leaf: every client a copy of every layer, and one server
copy of every layer. The program and the reference are handed the same
ones; each takes the copies its cut topology needs.

Draws: a dense weight uniform in +-sqrt(6 / (in + out)); a (transposed)
convolution's normal with std sqrt(2 / fan_in); an embedding table
normal / sqrt(dim); biases and BatchNorm's scale and shift near their
usual 0 and 1 (small normal draws, so that a swapped or dropped one
shows); running statistics 0 and 1.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference.cgan import layer_specs, leaf_shapes

# leaves: {(net, layer, side, path): tensor}, side "client" [K, ...] or
# "server" [...]
Weights = Dict[Tuple[str, int, str, str], torch.Tensor]


def _draw(path: str, shape, spec: dict, gen: torch.Generator, device):
    def normal(std):
        return torch.randn(shape, generator=gen, device=device) * std
    leaf = shape[1:]
    if path == "embed.table":
        return normal(1.0 / math.sqrt(leaf[-1]))
    if path == "fc.w":
        lim = math.sqrt(6.0 / (leaf[0] + leaf[1]))
        return torch.rand(shape, generator=gen, device=device) * 2 * lim - lim
    if path in ("conv.w", "convt.w"):
        cin = leaf[1] if path == "conv.w" else leaf[0]
        return normal(math.sqrt(2.0 / (cin * leaf[2] * leaf[3])))
    if path in ("fc.b", "conv.b", "convt.b", "bn.bias"):
        return normal(0.05)
    if path == "bn.scale":
        return 1.0 + normal(0.05)
    if path == "bn.mean":
        return torch.zeros(shape, device=device)
    if path == "bn.var":
        return torch.ones(shape, device=device)
    raise ValueError(path)


def make_weights(model: dict, K: int, seed: int, device) -> Weights:
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 2654435761 + 12345) % 2 ** 63)
    out: Weights = {}
    for net in ("G", "D"):
        for l, spec in enumerate(layer_specs(model, net)):
            for path, shape in leaf_shapes(model, spec).items():
                out[(net, l, "client", path)] = _draw(path, (K,) + shape,
                                                      spec, gen, device)
                out[(net, l, "server", path)] = _draw(path, (1,) + shape,
                                                      spec, gen, device)[0]
    return out
