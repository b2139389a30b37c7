#!/usr/bin/env python3
"""Where a dry run's peak bytes per card go: one (arch x input shape)
pair traced as ``python -m repro_torch.launch.dryrun`` traces it, with
the storages alive at its peak grouped by the operation that made them,
their shape and dtype.

    python3 scripts/dryrun_peak.py --arch granite-moe-1b-a400m \\
        --shape train_4k [--multi-pod] [--device cpu] [--dtensor-rules] \\
        [--top 12]

``--dtensor-rules`` turns the model's rank-local MoE and recurrence
branches off (``sharding.dtensor_ops.local_experts`` and
``local_recurrence`` then hand their DTensor inputs to DTensor's own
rules), to see what those rules hold. The trace runs in this process on
a fake process group of the mesh's size (meta tensors: nothing is
allocated). The composition is taken at the last time the live bytes
rose 0.5 % above the previous snapshot, so it is within 0.5 % of the
peak. It prints the record's FLOPs, collectives and memory, the groups
(count, bytes each, bytes in all), and one JSON line.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.launch import dryrun as D  # noqa: E402


class PeakCounter(D.OpCounter):
    """``OpCounter`` that remembers which operation made each storage
    and what was alive near the peak."""

    def __init__(self):
        super().__init__()
        self.made = {}
        self.op = "stand-in"        # a replayed call's fresh results
        self.snap, self.snap_bytes = {}, 0

    def track(self, tree):
        self.op = "argument"
        super().track(tree)
        self.op = "stand-in"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        outer, self.op = self.op, func._overloadpacket.__name__
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self.op = outer

    def _track(self, t):
        key = t.untyped_storage()._cdata
        if key not in self.live:
            self.made[key] = (self.op, tuple(t.shape), str(t.dtype))
        super()._track(t)
        if self.cur > self.snap_bytes * 1.005:
            self.snap = {k: (n, self.made[k]) for k, n in self.live.items()}
            self.snap_bytes = self.cur

    def _free(self, key):
        super()._free(key)
        self.made.pop(key, None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu)")
    ap.add_argument("--dtensor-rules", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    if args.dtensor_rules:
        from repro_torch.sharding import dtensor_ops as dt
        dt._expert_shards = lambda *a: None
        dt._recurrence_shards = lambda *a: None
    D.production_mesh(args.multi_pod, args.device)
    lowered, meta = D.build_lowered(args.arch, args.shape,
                                    multi_pod=args.multi_pod,
                                    device=args.device)
    counter = PeakCounter()
    out, _ = lowered.run(counter)
    groups = collections.defaultdict(lambda: [0, 0])
    for nbytes, made in counter.snap.values():
        g = groups[made]
        g[0] += 1
        g[1] += nbytes
    top = sorted(groups.items(), key=lambda kv: -kv[1][1])[:args.top]
    print(f"{args.arch} x {args.shape} x "
          f"{'2pod' if args.multi_pod else '1pod'}: flops "
          f"{counter.flops:.4e}, collectives "
          f"{sum(counter.collectives.values()):.4e} B, peak "
          f"{counter.peak / 2**30:.2f} GiB (snapshot "
          f"{counter.snap_bytes / 2**30:.2f} GiB)")
    for (op, shape, dtype), (n, nbytes) in top:
        print(f"  {n:5d} x {nbytes / n / 2**20:10.1f} MiB = "
              f"{nbytes / 2**30:8.2f} GiB  {op} {list(shape)} {dtype}")
    print(json.dumps({
        "arch": args.arch, "shape": args.shape,
        "multi_pod": args.multi_pod, "dtensor_rules": args.dtensor_rules,
        "flops": counter.flops, "peak_bytes": counter.peak,
        "snapshot_bytes": counter.snap_bytes,
        "collectives": counter.collectives,
        "groups": [{"op": op, "shape": list(shape), "dtype": dtype,
                    "count": n, "bytes": nbytes}
                   for (op, shape, dtype), (n, nbytes) in top]}))
    del out
    D.stop_fake_group()


if __name__ == "__main__":
    main()
