"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them. Inputs are made with numpy from a seed and handed to both.
Tests marked ``cuda`` launch the hand-written kernels and skip where
torch sees no GPU.

Tolerances: K1 sums K float32 products in another order on each side,
so outputs of order 1 agree to a few ulps; 1e-5 absolute and relative
leaves margin. K2 labels must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kmeans_assign import kmeans_assign as pallas_assign  # noqa: E402
from repro.kernels.weighted_agg import clustered_agg_flat as pallas_agg  # noqa: E402
from repro_torch.kernels import kmeans_assign as km  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import weighted_agg as wa  # noqa: E402
from repro_torch.kernels.ref import clustered_agg_ref, kmeans_assign_ref  # noqa: E402

AGG_TOL = 1e-5


def _agg_inputs(S, K, D, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(S, K))
    w = (np.exp(w) / np.exp(w).sum(1, keepdims=True)).astype(np.float32)
    return w, rng.normal(size=(K, D)).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("S,K,D", [(1, 3, 128), (1, 8, 10_001), (8, 8, 8192),
                                   (15, 32, 10_001),
                                   (24, 8, 3 * 8 * 1024 + 77)])
def test_clustered_agg_matches_pallas(S, K, D):
    w, theta = _agg_inputs(S, K, D, seed=S * 100 + K * 10 + D)
    before = wa.launches
    got = wa.clustered_agg_flat(torch.from_numpy(w), torch.from_numpy(theta))
    assert wa.launches == before, "a CPU tensor must not launch the kernel"
    want = pallas_agg(jnp.asarray(w), jnp.asarray(theta), interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=AGG_TOL,
                               atol=AGG_TOL)


def test_clustered_agg_op_keeps_trailing_shape():
    w, theta = _agg_inputs(2, 4, 3 * 7 * 5, seed=1)
    got = ops.clustered_agg(torch.from_numpy(w),
                            torch.from_numpy(theta).reshape(4, 3, 7, 5))
    assert tuple(got.shape) == (2, 3, 7, 5)
    np.testing.assert_allclose(got.reshape(2, -1).numpy(), w @ theta,
                               rtol=AGG_TOL, atol=AGG_TOL)


@pytest.mark.parametrize("N", [1, 8, 257])
@pytest.mark.parametrize("M", [2, 6])
@pytest.mark.parametrize("D", [32, 6272])
def test_kmeans_assign_matches_pallas(N, M, D):
    rng = np.random.default_rng(N + M + D)
    x = rng.normal(size=(N, D)).astype(np.float32)
    c = (rng.normal(size=(M, D)) * 3).astype(np.float32)
    got = km.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    want = np.asarray(pallas_assign(jnp.asarray(x), jnp.asarray(c),
                                    interpret=True))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kmeans_assign_exact_ties_pick_lowest_index():
    rng = np.random.default_rng(2)
    base = (rng.normal(size=(3, 64)) * 2).astype(np.float32)
    c = np.concatenate([base, base[::-1]], 0)          # rows 0..2 == 5..3
    x = (base + 0.01 * rng.normal(size=(3, 64))).astype(np.float32)
    got = km.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = np.asarray(pallas_assign(jnp.asarray(x), jnp.asarray(c),
                                    interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.arange(3))


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA never reaches a
    plain version: the wrapper raises."""
    meta = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError):
        wa.clustered_agg_flat(meta, meta)
    with pytest.raises(ValueError):
        km.kmeans_assign(meta, meta)


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,D", [(1, 8, 8 * 1024 + 3), (16, 8, 2_050_405),
                                   (24, 8, 671_585), (5, 3, 10_001)])
def test_clustered_agg_kernel_on_card(cuda, S, K, D):
    w, theta = _agg_inputs(S, K, D, seed=S + K + D)
    w, theta = torch.from_numpy(w).to(cuda), torch.from_numpy(theta).to(cuda)
    before = wa.launches
    got = wa.clustered_agg_flat(w, theta)
    torch.cuda.synchronize()
    assert wa.launches == before + 1
    torch.testing.assert_close(got, clustered_agg_ref(w, theta),
                               rtol=AGG_TOL, atol=AGG_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 3, 4, 9])
def test_kmeans_assign_kernel_on_card(cuda, M):
    gen = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn((8, 6272), generator=gen, device=cuda)
    c = torch.randn((M, 6272), generator=gen, device=cuda)
    before = km.launches
    got = km.kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    assert torch.equal(got, kmeans_assign_ref(x, c))
