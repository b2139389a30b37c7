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

``--by-site`` also attributes every FLOP and every collective to its
site: the innermost frame of ``repro_torch`` outside the dry run's own
module (file:line and function), the last DTensor operation dispatched
before it (whose redistributions issue the collectives) and the local
operation. The sites go into the JSON line under ``sites``; two
records of one pair traced under two torch versions differ where their
DTensor rules do.

``--diff A B`` compares two such records (files holding a ``--by-site``
run's output, its JSON line last): the totals, then every site whose
FLOPs or collective bytes of a kind differ, summed over its DTensor and
local operations (whose names a torch version may change), largest
difference first. It exits 1 if anything differs, 0 if nothing does:

    python3 scripts/dryrun_peak.py --arch xlstm-350m --shape decode_32k \
        --by-site > a.log            # on one torch version; b.log on another
    python3 scripts/dryrun_peak.py --diff a.log b.log
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
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.launch import dryrun as D  # noqa: E402


class PeakCounter(D.OpCounter):
    """``OpCounter`` that remembers which operation made each storage
    and what was alive near the peak."""

    def __init__(self, by_site: bool = False):
        super().__init__()
        self.made = {}
        self.op = "stand-in"        # a replayed call's fresh results
        self.snap, self.snap_bytes = {}, 0
        self.by_site = by_site
        self.sites = collections.defaultdict(collections.Counter)
        self.dt_op = "-"            # the last DTensor operation dispatched
        self.depth = 0

    def track(self, tree):
        self.op = "argument"
        super().track(tree)
        self.op = "stand-in"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if self.by_site and any(isinstance(t, DTensor) for t in
                                D._tensors((args, kwargs or {}))):
            self.dt_op = name
        outer, self.op = self.op, name
        before = (self.flops, dict(self.collectives), dict(self.calls))
        self.depth += 1
        try:
            return super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self.op = outer
            self.depth -= 1
            if self.by_site and self.depth == 0:
                self._attribute(name, *before)

    def _attribute(self, name, flops, coll, calls):
        """The FLOPs and collectives of one outermost local call, added
        to its site."""
        site = self.sites[(_frame(), self.dt_op, name)]
        if self.flops != flops:
            site["flops"] += self.flops - flops
        for kind, nb in self.collectives.items():
            if nb != coll.get(kind, 0.0):
                site[kind] += nb - coll.get(kind, 0.0)
                site[kind + " calls"] += self.calls[kind] - calls.get(kind, 0)

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


def _frame() -> str:
    """The innermost frame of ``repro_torch`` outside ``launch/dryrun.py``
    (file:line function)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path and not path.endswith("dryrun.py"):
            return (f"{path.split('repro_torch/')[-1]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "-"


def load_record(path: str) -> dict:
    """The last JSON line of a ``--by-site`` run's output in ``path``."""
    with open(path) as f:
        lines = [line for line in f if line.startswith("{")]
    if not lines:
        raise ValueError(f"{path}: no JSON line")
    return json.loads(lines[-1])


def _by_site(rec: dict) -> dict:
    """site -> {metric: value}: the FLOPs and the collective bytes by
    kind of each site, summed over its operations."""
    out = collections.defaultdict(collections.Counter)
    for s in rec.get("sites", []):
        for k, v in s.items():
            if k == "flops" or k in D.COLLECTIVE_KINDS.values():
                out[s["site"]][k] += v
    return out


def diff_records(a: dict, b: dict) -> list:
    """(site, metric, a's value, b's value) wherever two records differ:
    the totals first (site ``total``: FLOPs, peak bytes, each kind's
    collective bytes), then the sites, each group by the size of the
    difference, largest first."""
    def totals(r):
        return {"flops": r["flops"], "peak_bytes": r["peak_bytes"],
                **r["collectives"]}
    rows = [("total", k, totals(a).get(k, 0.0), totals(b).get(k, 0.0))
            for k in sorted(set(totals(a)) | set(totals(b)))]
    sa, sb = _by_site(a), _by_site(b)
    rows += [(site, k, sa[site][k], sb[site][k])
             for site in set(sa) | set(sb)
             for k in set(sa[site]) | set(sb[site])]
    rows = [r for r in rows if r[2] != r[3]]
    return sorted(rows, key=lambda r: (r[0] != "total", -abs(r[3] - r[2]),
                                       r[0], r[1]))


def main_diff(path_a: str, path_b: str) -> int:
    a, b = load_record(path_a), load_record(path_b)
    print(f"A {path_a}: {a['arch']} x {a['shape']}, torch {a['torch']}; "
          f"B {path_b}: {b['arch']} x {b['shape']}, torch {b['torch']}")
    rows = diff_records(a, b)
    for site, metric, va, vb in rows:
        print(f"  {site}  {metric}: A {va:.6g}  B {vb:.6g}  "
              f"(B - A {vb - va:+.6g})")
    print(f"{len(rows)} differences")
    return 1 if rows else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu)")
    ap.add_argument("--dtensor-rules", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--by-site", action="store_true",
                    help="attribute FLOPs and collectives to their sites")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"),
                    help="compare two --by-site runs' output files")
    args = ap.parse_args(argv)
    if args.diff:
        return main_diff(*args.diff)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --diff A B)")
    torch.set_num_threads(1)
    if args.dtensor_rules:
        from repro_torch.sharding import dtensor_ops as dt
        dt._expert_shards = lambda *a: None
        dt._recurrence_shards = lambda *a: None
    D.production_mesh(args.multi_pod, args.device)
    lowered, meta = D.build_lowered(args.arch, args.shape,
                                    multi_pod=args.multi_pod,
                                    device=args.device)
    counter = PeakCounter(by_site=args.by_site)
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
    sites = [{"site": k[0], "dtensor_op": k[1], "op": k[2], **v}
             for k, v in counter.sites.items() if v]
    for s in sorted(sites, key=lambda s: -sum(
            v for k, v in s.items() if k not in ("flops",) and
            isinstance(v, float)))[:args.top]:
        print("  site", json.dumps(s))
    print(json.dumps({
        "arch": args.arch, "shape": args.shape,
        "multi_pod": args.multi_pod, "dtensor_rules": args.dtensor_rules,
        "flops": counter.flops, "peak_bytes": counter.peak,
        "snapshot_bytes": counter.snap_bytes,
        "collectives": counter.collectives,
        "groups": [{"op": op, "shape": list(shape), "dtype": dtype,
                    "count": n, "bytes": nbytes}
                   for (op, shape, dtype), (n, nbytes) in top],
        "torch": torch.__version__, "sites": sites}))
    del out
    D.stop_fake_group()


if __name__ == "__main__":
    sys.exit(main())
