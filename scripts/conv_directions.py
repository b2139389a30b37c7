#!/usr/bin/env python3
"""Each direction of the GAN's convolutions on one NVIDIA GPU, NCHW
against channels-last: the forward pass, the input gradient (cuDNN's
backward-data) and the weight gradient, and the two copies between the
layouts, at ``gan100-train``'s shapes.

    python3 scripts/conv_directions.py [--out OUT.json]

The client convolutions run as the port runs a profile group: one
grouped convolution of K = 14 clients x 32 images (D's layers 0, 1 and
3, G's transposed layers 1, 3 and 4; a conv's input already padded as
``models.nn.conv2d_apply`` pads it). The server's run as one copy (K =
1) at the cell's rows: 480 (one group of 15 clients) or 3,200 (all).
Float32, TF32 off, as the benchmark runs. Each number is the mean of 20
calls between CUDA events after 3 warm-up calls, in ms. It prints the
card's name and power limit, one JSON line per layer, and writes them
all to ``--out``. ``models.nn`` takes a grouped convolution's input
gradient through NCHW from these numbers (``PERF.md``).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

CL = torch.channels_last
# name, transposed, C, O, kernel, stride, input size, padding, K, images
LAYERS = [("D0", False, 2, 64, 4, 2, 30, 0, 14, 32),
          ("D1", False, 64, 128, 4, 2, 16, 0, 14, 32),
          ("D3", False, 128, 256, 4, 2, 10, 0, 14, 32),
          ("G1", True, 256, 128, 4, 2, 7, 1, 14, 32),
          ("G3", True, 128, 64, 4, 2, 14, 1, 14, 32),
          ("G4", True, 64, 1, 3, 1, 28, 1, 14, 32),
          ("server D1", False, 64, 128, 4, 2, 16, 0, 1, 480),
          ("server D2", False, 128, 128, 3, 1, 9, 0, 1, 3200),
          ("server D3", False, 128, 256, 4, 2, 10, 0, 1, 480),
          ("server G1", True, 256, 128, 4, 2, 7, 1, 1, 480),
          ("server G2", True, 128, 128, 3, 1, 14, 1, 1, 3200),
          ("server G3", True, 128, 64, 4, 2, 14, 1, 1, 480)]


def timed(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def layer(dev, gen, tr, C, O, k, s, H, pad, K, B) -> dict:
    x0 = torch.randn(B, K * C, H, H, device=dev, generator=gen)
    w = torch.randn((K * C, O, k, k) if tr else (K * O, C, k, k),
                    device=dev, generator=gen) * 0.05

    def fwd(x):
        if tr:
            return F.conv_transpose2d(x, w, stride=s, padding=pad, groups=K)
        return F.conv2d(x, w, stride=s, padding=pad, groups=K)

    y0 = fwd(x0)
    row = {"x": list(x0.shape), "y": list(y0.shape)}
    for name, fmt in (("nchw", torch.contiguous_format), ("cl", CL)):
        x = x0.contiguous(memory_format=fmt)
        gy = torch.randn_like(y0).contiguous(memory_format=fmt)

        def bwd(mask, x=x, gy=gy):
            return torch.ops.aten.convolution_backward(
                gy, x, w, None, [s, s], [pad, pad], [1, 1], tr, [0, 0], K,
                mask)
        row[name] = {"fwd": timed(lambda x=x: fwd(x)),
                     "dgrad": timed(lambda: bwd([True, False, False])),
                     "wgrad": timed(lambda: bwd([False, True, False]))}
    xc, yc = x0.contiguous(memory_format=CL), y0
    row["copy_x_cl_to_nchw"] = timed(lambda: xc.contiguous())
    row["copy_y_nchw_to_cl"] = timed(lambda: yc.contiguous(memory_format=CL))
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_directions: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"card": card, "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version(), "layers": {}}
    for name, *shape in LAYERS:
        res["layers"][name] = layer(dev, gen, *shape)
        print(json.dumps({name: res["layers"][name]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
