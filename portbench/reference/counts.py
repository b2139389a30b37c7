"""Operation and byte counts from the configuration's Table-3 shapes,
behind ``step_mfu``. Never counted from what the
program runs.

A training step, per image: the D update runs G forward once (the fake
images), D forward on the real and on the fake images, and D's backward
on both (weight gradients of every layer; input gradients of every
layer, the first layer's for its label-embedding channel alone, which
trains the embedding); the G update runs G forward, D forward, D's
backward for input gradients only (D is not updated there; the first
layer's for its image channel alone) and G's backward (weight gradients
of every layer; input gradients of every layer, the first layer's for
its label-embedding inputs alone: z needs none). Each product is
counted once: nothing is recomputed. A convolution's multiply-adds are output pixels
x in x out channels x k x k; a transposed convolution's are input
pixels x in x out x k x k (it scatters each input pixel); a dense
layer's are in x out. Embedding lookups, BatchNorm and activations are
not products and are not counted. One multiply-add is 2 FLOPs.
"""
from __future__ import annotations

from typing import Dict, List

from portbench.reference.cgan import layer_specs, same_pads


def layer_macs(model: dict, net: str) -> List[int]:
    """Forward multiply-adds per image of every layer of ``net``."""
    hw = model["img"]
    out = []
    if net == "G":
        size = None
        for spec in layer_specs(model, "G"):
            if spec["kind"] == "embed_dense":
                h, w, c = spec["out_hwc"]
                out.append(spec["in_dim"] * h * w * c)
                size = h
            else:
                out.append(size * size * spec["cin"] * spec["cout"]
                           * spec["k"] ** 2)
                size *= spec["stride"]
        return out
    size = hw
    for spec in layer_specs(model, "D"):
        if spec["kind"] == "dense":
            out.append(spec["in_dim"] * spec["out_dim"])
            continue
        k, s = spec["k"], spec["stride"]
        lo, hi = same_pads(size, k, s)
        size = (size + lo + hi - k) // s + 1
        out.append(size * size * spec["cin"] * spec["cout"] * k * k)
    return out


def step_flops_per_image(model: dict) -> Dict[str, int]:
    """FLOPs of one training step per image, by part (see the module
    docstring) and in ``total``."""
    g, d = layer_macs(model, "G"), layer_macs(model, "D")
    G, D = sum(g), sum(d)
    g0, d0 = model["generator"][0], model["discriminator"][0]
    g_emb = g[0] * g0["embed_dim"] / g0["in_dim"]   # G's label inputs
    d_chan = d[0] / d0["cin"]                       # one of D's channels
    parts = {
        "d_step.g_forward": G,
        "d_step.d_forward_real_fake": 2 * D,
        "d_step.d_weight_grads_real_fake": 2 * D,
        "d_step.d_input_grads_real_fake": 2 * (D - d[0] + d_chan),
        "g_step.g_forward": G,
        "g_step.d_forward": D,
        "g_step.d_input_grads": D - d[0] + d_chan,
        "g_step.g_weight_grads": G,
        "g_step.g_input_grads": G - g[0] + g_emb,
    }
    out = {k: 2.0 * v for k, v in parts.items()}
    out["total"] = sum(out.values())
    return out
