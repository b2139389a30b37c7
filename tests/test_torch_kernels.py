"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the
Pallas kernels run in interpret mode, as tests/test_kernels.py runs
them. Inputs are made with numpy from a seed and handed to both.
Tests marked ``cuda`` launch the hand-written kernels and skip where
torch sees no GPU.

Tolerances: K1 sums K float32 products in another order on each side,
so outputs of order 1 agree to a few ulps; 1e-5 absolute and relative
leaves margin. K2 labels must be equal. K3 and K4 take the JAX kernel
tests' float32 tolerance, 2e-5: an online softmax and a dense one sum
the same terms in another order. Rows of K3 past their length are
garbage by contract and are not compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as pallas_ops  # noqa: E402
from repro.kernels.kmeans_assign import kmeans_assign as pallas_assign  # noqa: E402
from repro.kernels.weighted_agg import clustered_agg_flat as pallas_agg  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import kmeans_assign as km  # noqa: E402
from repro_torch.kernels import mem_attention as ma  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import weighted_agg as wa  # noqa: E402
from repro_torch.kernels.ref import (clustered_agg_ref, flash_decode_ref,  # noqa: E402
                                     kmeans_assign_ref, mem_attention_ref)

AGG_TOL = 1e-5
ATTN_TOL = 2e-5


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


def _attn_inputs(B, Sq, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _valid_rows(x, lens):
    """Zero the rows of [B, S, ...] at or past each batch row's length."""
    S = x.shape[1]
    mask = np.arange(S)[None, :] < np.asarray(lens)[:, None]
    return np.where(mask.reshape(mask.shape + (1,) * (x.ndim - 2)), x, 0.0)


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 37, 4, 4, 16, True), (2, 37, 4, 2, 16, False),
    (2, 100, 8, 2, 8, True), (1, 130, 6, 3, 32, False),
    (2, 64, 4, 1, 16, True)])
def test_mem_attention_matches_pallas(B, S, H, KV, hd, causal):
    q, k, v = _attn_inputs(B, S, S, H, KV, hd, seed=B * S + hd)
    lens = np.asarray([S - 3 * i for i in range(B)], np.int32)
    got = ops.mem_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(lens),
                            causal=causal)
    want = np.asarray(pallas_ops.mem_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        causal=causal))
    assert tuple(got.shape) == (B, S, H, hd)
    np.testing.assert_allclose(_valid_rows(got.numpy(), lens),
                               _valid_rows(want, lens), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 64, 4, 2, 16),
                                         (1, 600, 8, 2, 32),
                                         (3, 100, 6, 6, 8)])
def test_flash_decode_matches_pallas(B, S, H, KV, hd):
    q, k, v = _attn_inputs(B, 1, S, H, KV, hd, seed=B * S + hd)
    q = q[:, 0]
    for clen in (1, S - 7, S):
        got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), clen)
        want = np.asarray(pallas_ops.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(clen, jnp.int32)))
        assert tuple(got.shape) == (B, H, hd)
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                                   rtol=ATTN_TOL)


def test_attention_plain_versions_take_int_or_tensor_lengths():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(2, 24, 24, 4, 2, 16,
                                                         seed=9))
    # causal rows before the length do not see the keys past it
    lens = torch.tensor([20, 20], dtype=torch.int32)
    a = ops.mem_attention(q, k, v, lens)[:, :20]
    b = ops.mem_attention(q[:, :20], k[:, :20], v[:, :20], lens)
    torch.testing.assert_close(a, b, atol=ATTN_TOL, rtol=ATTN_TOL)
    a = ops.flash_decode(q[:, 5], k, v, 11)
    b = ops.flash_decode(q[:, 5], k, v, torch.tensor(11, dtype=torch.int32))
    assert torch.equal(a, b)
    # causal prefill row t is one decode step against a t+1 row cache
    full = ops.mem_attention(q, k, v, torch.tensor([24, 24],
                                                   dtype=torch.int32))
    for t in (0, 7, 23):
        torch.testing.assert_close(ops.flash_decode(q[:, t], k, v, t + 1),
                                   full[:, t], atol=ATTN_TOL, rtol=ATTN_TOL)


def test_attention_wrappers_launch_or_raise_off_the_cpu():
    meta = torch.empty((1, 8, 2, 16), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    before = (ma.launches, fd.launches)
    with pytest.raises(ValueError):
        ma.mem_attention(meta, meta, meta, lens)
    with pytest.raises(ValueError):
        fd.flash_decode(meta[:, 0], meta, meta, 4)
    assert (ma.launches, fd.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [37, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_mem_attention_kernel_on_card(cuda, hd, G, S, causal):
    B, KV = 2, 2
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _attn_inputs(
        B, S, S, KV * G, KV, hd, seed=hd + G + S))
    lens = torch.tensor([S, S - 5], dtype=torch.int32, device=cuda)
    before = ma.launches
    got = ma.mem_attention(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    assert ma.launches == before + 1
    want = mem_attention_ref(q, k, v, lens, causal=causal)
    lens_np = lens.cpu().numpy()
    np.testing.assert_allclose(_valid_rows(got.cpu().numpy(), lens_np),
                               _valid_rows(want.cpu().numpy(), lens_np),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [64, 1000])
def test_flash_decode_kernel_on_card(cuda, hd, G, S):
    B, KV = 2, 2
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _attn_inputs(
        B, 1, S, KV * G, KV, hd, seed=hd + G + S))
    q = q[:, 0].contiguous()
    # 33 and 47: the cache lengths the split LM's decode loop gives
    for clen in (1, 33, 47, S - 7, S):
        for length in (clen, torch.tensor(clen, dtype=torch.int32,
                                          device=cuda)):
            before = fd.launches
            got = fd.flash_decode(q, k, v, length)
            torch.cuda.synchronize()
            assert fd.launches == before + 1
            torch.testing.assert_close(got, flash_decode_ref(q, k, v, clen),
                                       atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.cuda
def test_attention_kernels_ignore_masked_cache_on_card(cuda):
    """Corrupting K/V at or past the length changes no valid output."""
    B, S, H, KV, hd = 2, 48, 4, 2, 16
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _attn_inputs(
        B, S, S, H, KV, hd, seed=7))
    lens = torch.tensor([30, 17], dtype=torch.int32, device=cuda)
    k2, v2 = k.clone(), v.clone()
    k2[:, 17:], v2[:, 17:] = 55.0, -55.0
    a = ma.mem_attention(q, k, v, lens)
    b = ma.mem_attention(q, k2, v2, lens)
    assert torch.equal(a[1, :17], b[1, :17])
    a = fd.flash_decode(q[:, 3].contiguous(), k, v, 17)
    b = fd.flash_decode(q[:, 3].contiguous(), k2, v2, 17)
    assert torch.equal(a, b)


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
