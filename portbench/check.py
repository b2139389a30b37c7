"""The comparison that decides ``correct``: each number a driver's
``judge()`` gives against its limit, and the gaps those numbers are
made of (a driver's docstring says what it compares)."""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple


def worst_norm_gap(prog: Dict, ref: Dict, grad_ref: Dict,
                   keys: Iterable) -> float:
    """Worst leaf of |prog - ref| / max(ref, median ref) over ``keys``
    (norms by leaf) whose reference gradient norm is at least a
    thousandth of the median leaf's."""
    keys = list(keys)
    med_g = _median(grad_ref[k] for k in keys)
    keep = [k for k in keys if grad_ref[k] >= 1e-3 * med_g]
    med = _median(ref[k] for k in keep)
    worst = 0.0
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def leaf_diff_gap(prog: Dict, ref: Dict) -> float:
    """Worst leaf of ‖prog - ref‖ / max(‖ref‖, median ‖ref‖)."""
    rn = {k: float(v.double().norm()) for k, v in ref.items()}
    med = _median(rn.values())
    worst = 0.0
    for k, v in ref.items():
        d = float((prog[k].double() - v.double()).norm())
        gap = d / max(rn[k], med, 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def _median(xs) -> float:
    xs = sorted(xs)
    if not xs:
        return 0.0
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def rel_gap(a: float, b: float) -> float:
    g = abs(a - b) / max(abs(b), 1e-30)
    return g if math.isfinite(g) else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` (every number finite and at or under its limit, and
    every limit read) and each number beside its limit."""
    shown = {}
    ok = True
    for name, lim in limits.items():
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": lim}
        if v is None or not math.isfinite(v) or v > lim:
            ok = False
    return ok, shown
