"""The port's public initialisers (``repro_torch.models.nn``
``glorot_uniform``, ``he_normal``, ``truncated_normal``) against the
reference's definitions (``repro.models.nn``).

Both packages draw from their own generators, so the test holds the
moments of large draws to their analytic values and the reference's
samples to the same bounds: the mean within 4 standard errors of 0, the
standard deviation within 1 %, Glorot's range within its limit and the
truncation at exactly 2 std. The fan-in/fan-out rules are the
reference's, shape by shape, exactly.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.models import nn as tnn  # noqa: E402

N = 200_000
SHAPES = [(4096,), (64, 96), (3, 3, 16, 32), (5, 5, 1, 64)]
# the standard deviation of a unit normal truncated to [-2, 2]
TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                      / math.erf(2 / math.sqrt(2)))


def _check_moments(x: np.ndarray, std: float) -> None:
    assert abs(x.mean()) < 4 * std / math.sqrt(x.size)
    assert abs(x.std() / std - 1) < 0.01


@pytest.mark.parametrize("shape", SHAPES)
def test_fans_match_the_reference(shape):
    from repro.models import nn as rnn
    assert tnn._fan_in_out(shape) == rnn._fan_in_out(shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_glorot_uniform(shape):
    import jax
    from repro.models import nn as rnn
    fan_in, fan_out = tnn._fan_in_out(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    reps = -(-N // math.prod(shape))
    gen = torch.Generator().manual_seed(0)
    x = np.concatenate([tnn.glorot_uniform(shape, gen, "cpu").numpy().ravel()
                        for _ in range(reps)])
    keys = jax.random.split(jax.random.PRNGKey(0), reps)
    ref = np.concatenate([np.asarray(rnn.glorot_uniform(k, shape)).ravel()
                          for k in keys])
    for v in (x, ref):
        assert np.abs(v).max() <= limit
        _check_moments(v, limit / math.sqrt(3))


@pytest.mark.parametrize("shape", SHAPES)
def test_he_normal(shape):
    import jax
    from repro.models import nn as rnn
    std = math.sqrt(2.0 / tnn._fan_in_out(shape)[0])
    reps = -(-N // math.prod(shape))
    gen = torch.Generator().manual_seed(1)
    x = np.concatenate([tnn.he_normal(shape, gen, "cpu").numpy().ravel()
                        for _ in range(reps)])
    keys = jax.random.split(jax.random.PRNGKey(1), reps)
    ref = np.concatenate([np.asarray(rnn.he_normal(k, shape)).ravel()
                          for k in keys])
    for v in (x, ref):
        _check_moments(v, std)


@pytest.mark.parametrize("std", [0.02, 1.0])
def test_truncated_normal(std):
    import jax
    from repro.models import nn as rnn
    gen = torch.Generator().manual_seed(2)
    x = tnn.truncated_normal((N,), gen, "cpu", std=std).numpy()
    ref = np.asarray(rnn.truncated_normal(jax.random.PRNGKey(2), (N,),
                                          std=std))
    for v in (x, ref):
        assert np.abs(v).max() <= 2 * std * (1 + 1e-6)
        assert np.abs(v).max() > 1.99 * std      # the tails reach 2 std
        _check_moments(v, std * TRUNC_STD)


def test_dtype_and_device():
    gen = torch.Generator().manual_seed(3)
    for fn in (tnn.glorot_uniform, tnn.he_normal, tnn.truncated_normal):
        x = fn((8, 4), gen, "cpu", dtype=torch.bfloat16)
        assert x.dtype == torch.bfloat16 and x.device.type == "cpu"
