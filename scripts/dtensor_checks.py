#!/usr/bin/env python3
"""The checks of ``tests/test_torch_dtensor_ops.py`` without pytest: its
4-rank body (gloo on the CPU) and the same assertions, for a machine
that should import neither jax nor the JAX package (``tests/conftest.py``
imports jax).

    python3 scripts/dtensor_checks.py

Runs every test of the module that reads the ranks, at each of its
parameters. Prints one JSON line (seconds, the largest relative
difference from the plain path, the number of checks, rank 0's values)
and ``DTENSOR CHECKS PASSED``; exits non-zero on the first failed check.
"""
import inspect
import json
import os
import sys
import time

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [os.path.join(root, "src"), os.path.join(root, "tests")]
    import test_torch_dtensor_ops as m
    from repro_torch.launch import mesh
    t = time.time()
    outs = mesh.run_ranks(4, m._rank_body, device_type="cpu", timeout=900)
    # every test of the module that reads the ranks, at each of its
    # parameters
    checks = 0
    for name in sorted(dir(m)):
        fn = getattr(m, name)
        if not name.startswith("test_") or \
                list(inspect.signature(fn).parameters)[:1] != ["ranks"]:
            continue
        marks = [k for k in getattr(fn, "pytestmark", [])
                 if k.name == "parametrize"]
        several = bool(marks) and "," in marks[0].args[0]
        for args in ([tuple(v) if several else (v,)
                      for v in marks[0].args[1]] if marks else [()]):
            fn(outs, *args)
            checks += 1
    worst = max(max(o[k] for k in m.VALUES) for o in outs)
    print(json.dumps({"seconds": time.time() - t, "worst_rel": worst,
                      "checks": checks, "rank0": outs[0]}))
    print("DTENSOR CHECKS PASSED")
