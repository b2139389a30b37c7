"""Shared fixtures. NOTE: no XLA_FLAGS device forcing here — smoke tests
and benches must see the single real CPU device (the 512-device override
is exclusive to repro/launch/dryrun.py).

Multi-device pattern (the ``multihost`` fixture)
------------------------------------------------
Sharded code paths (shard_map federation rounds, mesh-keyed plans) need
N > 1 devices, but ``--xla_force_host_platform_device_count`` is read
exactly once at backend init — it cannot be applied in this process
after jax has been imported (and every test module imports jax). So
sharded tests are written as plain, importable, argument-repr-able
check functions (``_check_*``) plus a thin pytest wrapper that hands
them to ``multihost``:

* On the ordinary 1-device suite, ``multihost`` re-runs the check in a
  spawned subprocess whose environment (built once per session by the
  session-scoped ``_multihost_env`` guard) forces 8 host CPU devices
  *before* jax import. A failing assert fails the subprocess, which
  fails the wrapping test with the child's output attached.
* When the current process itself already has >= 8 devices (the second
  pytest invocation in scripts/ci_smoke.sh runs with the flag set),
  the check runs inline — same assertions, no subprocess tax.

Checks requiring a specific mesh size pick 1/2/4/8 devices out of the
forced 8 via repro.launch.mesh.make_federation_mesh.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

FORCED_DEVICES = 8
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def _multihost_env():
    """Session-scoped env guard: the subprocess environment forcing
    FORCED_DEVICES CPU devices (flag replaced, platform pinned to cpu
    — see launch.mesh.forced_device_env) with src/tests on PYTHONPATH,
    computed once."""
    from repro.launch.mesh import forced_device_env
    return forced_device_env(
        FORCED_DEVICES, [os.path.join(_ROOT, "src"),
                         os.path.join(_ROOT, "tests")])


class _MultiHost:
    def __init__(self, env, inline):
        self._env = env
        self.inline = inline

    def __call__(self, module: str, func: str, *args, timeout: int = 900):
        """Run ``module.func(*args)`` under >= FORCED_DEVICES devices.

        ``args`` must round-trip through repr (ints/floats/strs/tuples)
        so the call can be serialized onto a subprocess command line.
        """
        if self.inline:
            import importlib
            getattr(importlib.import_module(module), func)(*args)
            return
        code = f"import {module} as _m; _m.{func}(*{args!r})"
        proc = subprocess.run([sys.executable, "-c", code], env=self._env,
                              cwd=_ROOT, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            pytest.fail(
                f"multihost subprocess {module}.{func}{args!r} failed "
                f"(rc={proc.returncode})\n--- stdout ---\n{proc.stdout}"
                f"\n--- stderr ---\n{proc.stderr}", pytrace=False)


@pytest.fixture(scope="session")
def multihost(_multihost_env):
    return _MultiHost(_multihost_env,
                      inline=jax.device_count() >= FORCED_DEVICES)
