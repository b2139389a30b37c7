"""Reading a ``torch.profiler`` trace of the card: the device's busy
time as the union of its activities' intervals (kernels, copies,
fills), device time by kernel name, and the idle gaps between device
activities labelled by the host operation that ran across them. The
union's arithmetic is ``chip_smoke.py``'s ``busy_us``."""
from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

LABELLED_GAPS = 2000


def union_length(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(spans):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return total if cur_e is None else total + cur_e - cur_s


def merged(spans) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s0, e0 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return [(a, b) for a, b in out]


def read_events(prof):
    """(device activities, host operations) of a finished profile, each
    a list of (name, start_s, end_s)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            # record_function's ranges, which also appear on the
            # device's timeline: spans, not device work
            if e.device_type() != DeviceType.CUDA:
                host.append((e.name(), e.start_ns() / 1e9,
                             (e.start_ns() + e.duration_ns()) / 1e9))
            continue
        s = e.start_ns() / 1e9
        t = s + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), s, t))
        else:
            host.append((e.name(), s, t))
    return dev, host


def summarize(dev, host, t0: float, t1: float, top: int = 10) -> Dict:
    """Busy seconds of the device within [t0, t1] (seconds on the
    trace's clock), device seconds by kernel name, and idle seconds by
    the innermost host operation covering each gap's middle."""
    spans = [(max(s, t0), min(e, t1)) for _, s, e in dev if e > t0 and s < t1]
    busy = union_length(spans)
    by_name: Dict[str, float] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps = []
    prev = t0
    for s, e in merged(spans) + [(t1, t1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    longs = [h for h in host_sorted if h[2] - h[1] > 1e-3]
    idle: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        best = None
        for n, s, e in host_sorted[max(0, i - 500):i] + longs:
            if s <= mid <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
        label = best[0] if best else "no host operation"
        idle[label] = idle.get(label, 0.0) + (b - a)
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:])
    if rest:
        idle["(shorter gaps, unlabelled)"] = rest
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": t1 - t0,
            "device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[n[:120], v] for n, v in gaps_top],
            "device_by_name": by_name}
