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
garbage by contract and are not compared. The split-and-combine twin of
K4 and the numpy 3xTF32 emulation of K3 take the same 2e-5: the split
only regroups the same softmax sums, and 3xTF32 products keep ~2^-22
relative error per operand, far inside it.
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
                                     flash_decode_split_ref,
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


@pytest.mark.parametrize("S", [64, 1000])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
def test_flash_decode_split_ref_matches_pallas(S, G, n_splits):
    """The split kernel's arithmetic (even pieces of ceil(len / n) rows,
    per-piece max, denominator and accumulator, then the combine) equals
    the TPU kernel, empty pieces and cache_len 0 included."""
    B, KV, hd = 2, 2, 16
    q, k, v = _attn_inputs(B, 1, S, KV * G, KV, hd, seed=S + G)
    q = q[:, 0]
    for clen in sorted({0, 1, n_splits - 1, S - 7, S}):
        got = flash_decode_split_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), clen, n_splits)
        want = np.asarray(pallas_ops.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(clen, jnp.int32)))
        assert tuple(got.shape) == (B, KV * G, hd)
        np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                                   rtol=ATTN_TOL, err_msg=f"clen={clen}")


@pytest.mark.parametrize("B,KV,S", [(1, 1, 1), (2, 2, 64), (1, 8, 32768),
                                    (8, 8, 32768), (4, 2, 1000),
                                    (64, 8, 300), (1, 1, 10 ** 6)])
def test_decode_splits_stays_within_the_rows(B, KV, S):
    n = fd.decode_splits(B, KV, S, 132)
    assert 1 <= n <= fd.MAX_SPLITS
    assert n <= max(1, S // fd.MIN_SPLIT_ROWS)


@pytest.mark.parametrize("S,n", [(64, 1), (1000, 3), (4096, 16),
                                 (32768, 49)])
def test_split_boundary_lengths_probe_every_edge(S, n):
    lens = fd.split_boundary_lengths(S, n)
    assert lens == sorted(set(lens)) and 1 <= lens[0] and lens[-1] == S
    per = -(-S // n)
    for edge in (per, S - 7, S):
        assert edge in lens
    if n > 1:
        assert {per - 1, per + 1, n - 1} <= set(lens)


def test_decode_splits_fills_the_card_and_leaves_short_caches_whole():
    # the split LM's decode shape: one split, so no combine
    assert fd.decode_splits(2, 2, 64, 132) == 1
    # granite-3-2b at B 1 and B 8: B * KV = 8 and 64 blocks alone leave
    # most of 132 SMs idle; the splits give several blocks per SM in one
    # resident wave
    for B, KV in ((1, 8), (8, 8)):
        blocks = fd.decode_splits(B, KV, 32768, 132) * B * KV
        assert 2 * 132 <= blocks <= fd.BLOCKS_PER_SM * 132


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32 rounds."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mma3(acc, a, b):
    """acc + a @ b as K3 issues it: each operand split into a TF32 big
    part and a TF32 residual, three products summed in float32."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    acc = acc + a_s @ bb
    acc = acc + ab @ b_s
    return acc + ab @ bb


def _mem_attention_3xtf32(q, k, v, lens, causal, bk):
    """K3's arithmetic in numpy float32: key tiles of ``bk`` rows, scores
    in the log2 domain, online softmax, both products in 3xTF32, each
    tile's P V summed alone and then added to the running output."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = np.float32(np.log2(np.e) / np.sqrt(hd))
    qpos = np.arange(S)[:, None]
    out = np.zeros_like(q)
    for b in range(B):
        n = int(lens[b])
        for h in range(H):
            qh, kh, vh = q[b, :, h], k[b, :, h // G], v[b, :, h // G]
            m = np.full(S, -1e30, np.float32)
            l = np.zeros(S, np.float32)
            o = np.zeros((S, hd), np.float32)
            for k0 in range(0, n, bk):
                k1 = min(k0 + bk, n)
                kpos = np.arange(k0, k1)[None, :]
                ok = (kpos <= qpos) if causal else np.ones((S, k1 - k0), bool)
                s = _mma3(np.zeros((S, k1 - k0), np.float32), qh,
                          kh[k0:k1].T) * scale
                s = np.where(ok, s, np.float32(-1e30))
                mx = np.maximum(m, s.max(1))
                corr = np.exp2(m - mx)
                p = np.where(ok, np.exp2(s - mx[:, None]), np.float32(0))
                l = l * corr + p.sum(1, dtype=np.float32)
                pv = _mma3(np.zeros((S, hd), np.float32), p, vh[k0:k1])
                o = o * corr[:, None] + pv
                m = mx
            out[b, :, h] = o / np.maximum(l, np.float32(1e-30))[:, None]
    return out


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_mem_attention_3xtf32_arithmetic_matches_pallas(hd, causal):
    """The premise of K3's tensor-core route: 3xTF32 products with the
    kernel's online softmax stay within 2e-5 of the TPU kernel."""
    B, S, H, KV = 2, 300, 4, 2
    q, k, v = _attn_inputs(B, S, S, H, KV, hd, seed=hd + causal)
    lens = np.asarray([S, S - 5], np.int32)
    got = _mem_attention_3xtf32(q, k, v, lens, causal,
                                bk=64 if hd <= 64 else 8)   # K3's key tiles
    want = np.asarray(pallas_ops.mem_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        causal=causal))
    np.testing.assert_allclose(_valid_rows(got, lens), _valid_rows(want, lens),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    # one TF32 product alone would not hold the tolerance
    one = np.where(np.abs(_tf32(q[0, :, 0]) @ _tf32(k[0, :, 0]).T
                          - q[0, :, 0] @ k[0, :, 0].T) > ATTN_TOL, 1, 0)
    assert one.any()


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
@pytest.mark.parametrize("hd", [8, 16, 64, 128, 256])
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
@pytest.mark.parametrize("hd", [8, 16, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("S", [64, 1000, 4096])
def test_flash_decode_kernel_on_card(cuda, hd, G, S):
    B, KV = 2, 2
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _attn_inputs(
        B, 1, S, KV * G, KV, hd, seed=hd + G + S))
    q = q[:, 0].contiguous()
    n = fd.decode_splits(B, KV, S, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    # 33 and 47: the cache lengths the split LM's decode loop gives
    for clen in sorted(set(fd.split_boundary_lengths(S, n)) | {33, 47}):
        for length in (clen, torch.tensor(clen, dtype=torch.int32,
                                          device=cuda)):
            before = fd.launches
            got = fd.flash_decode(q, k, v, length)
            torch.cuda.synchronize()
            assert fd.launches == before + 1
            torch.testing.assert_close(got, flash_decode_ref(q, k, v, clen),
                                       atol=ATTN_TOL, rtol=ATTN_TOL)
    # an empty cache gives zeros, as the TPU kernel and the split twin do
    zero = torch.tensor(0, dtype=torch.int32, device=cuda)
    assert torch.equal(fd.flash_decode(q, k, v, zero), torch.zeros_like(q))
    torch.testing.assert_close(flash_decode_split_ref(q, k, v, 0, n),
                               torch.zeros_like(q))


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
    # the same over a cache long enough to be split across blocks
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _attn_inputs(
        B, 1, 4096, H, KV, hd, seed=8))
    k2, v2 = k.clone(), v.clone()
    k2[:, 1000:], v2[:, 1000:] = 55.0, -55.0
    q = q[:, 0].contiguous()
    assert torch.equal(fd.flash_decode(q, k, v, 1000),
                       fd.flash_decode(q, k2, v2, 1000))


@pytest.mark.cuda
def test_attention_kernels_reject_misaligned_tensors_on_card(cuda):
    """The kernels copy 16 bytes at a time: a contiguous view that starts
    off a 16-byte boundary is refused, not read wrongly."""
    B, S, H, KV, hd = 1, 8, 2, 1, 16
    flat = torch.zeros(B * S * H * hd + 1, device=cuda)
    q = flat[1:].view(B, S, H, hd)
    k = torch.zeros((B, S, KV, hd), device=cuda)
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda)
    before = (ma.launches, fd.launches)
    with pytest.raises(ValueError, match="aligned"):
        ma.mem_attention(q, k, k, lens)
    with pytest.raises(ValueError, match="aligned"):
        fd.flash_decode(q[:, 0], k, k, S)
    assert (ma.launches, fd.launches) == before


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
