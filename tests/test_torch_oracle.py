"""K1's S = 1 entry point and the legacy federation oracle of the port
against the JAX package: ``kernels.weighted_agg_flat``, ``ref.
weighted_agg_ref``, ``ops.weighted_agg``, ``federation.
weighted_average_stacked`` and ``federate_client_params(fused=False)``;
then the port's fused round against its own legacy loop, and the plan's
padded-stride flat buffer.

Inputs are made with numpy from a seed and handed to both packages; the
Pallas kernels run in interpret mode. Tolerance: float32 weighted sums
of a few terms, taken in another order on each side, agree within 1e-6
relative to each output's scale (at least 1). A bfloat16 input is summed
in float32 on both sides and cast back, so the two may round a sum that
lies within float32 noise of a bfloat16 rounding boundary to
neighbouring values: they agree within one bfloat16 ulp (2^-8 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import federation as jfed  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.weighted_agg import weighted_agg_flat as pallas_wagg  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import federation as tfed  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import weighted_agg as wa  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

from test_torch_fed import fed_setup  # noqa: E402,F401
from test_torch_population import population  # noqa: E402,F401

REL = 1e-6
BF16_ULP = 2.0 ** -8


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= rel * scale, (err, rel * scale)


def _inputs(K, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K,) + shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, K)
    return x, (w / w.sum()).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("K,D", [(1, 7), (3, 1001), (8, 4099), (13, 10_001)])
def test_weighted_agg_flat_matches_pallas(K, D):
    x, w = _inputs(K, (D,), seed=K + D)
    before = wa.launches
    got = wa.weighted_agg_flat(torch.from_numpy(x), torch.from_numpy(w))
    assert wa.launches == before, "a CPU tensor must not launch the kernel"
    want = pallas_wagg(jnp.asarray(x), jnp.asarray(w), interpret=True)
    assert got.dtype == torch.float32 and tuple(got.shape) == (D,)
    _close(got.numpy(), want)
    _close(tref.weighted_agg_ref(torch.from_numpy(x), torch.from_numpy(w)),
           jref.weighted_agg_ref(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("K,D", [(3, 1001), (6, 4099)])
def test_weighted_agg_flat_casts_bf16_back(K, D):
    x, w = _inputs(K, (D,), seed=7 * K + D)
    xb = _bf16(x)
    got = wa.weighted_agg_flat(xb, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    want = pallas_wagg(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                       jnp.asarray(w), interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           rel=BF16_ULP)


@pytest.mark.parametrize("shape", [(5,), (3, 7, 5), (2, 1, 33)])
@pytest.mark.parametrize("bf16", [False, True])
def test_weighted_agg_op_keeps_trailing_shape(shape, bf16):
    x, w = _inputs(4, shape, seed=len(shape))
    xt = _bf16(x) if bf16 else torch.from_numpy(x)
    xj = jnp.asarray(xt.float().numpy())
    xj = xj.astype(jnp.bfloat16) if bf16 else xj
    got = tops.weighted_agg(xt, torch.from_numpy(w))
    want = jops.weighted_agg(xj, jnp.asarray(w))
    assert tuple(got.shape) == shape == want.shape
    assert got.dtype == xt.dtype
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           rel=BF16_ULP if bf16 else REL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_weighted_average_stacked_matches_reference(use_kernel):
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(5, 3, 3, 7)).astype(np.float32),
            "b": rng.normal(size=(5, 1001)).astype(np.float32),
            "bn": {"scale": rng.normal(size=(5, 9)).astype(np.float32)}}
    w = rng.uniform(0.1, 1, 5)
    w = (w / w.sum()).astype(np.float32)
    want = jfed.weighted_average_stacked(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w),
        use_kernel=use_kernel)
    got = tfed.weighted_average_stacked(
        {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()})
         for k, v in tree.items()}, torch.from_numpy(w),
        use_kernel=use_kernel)
    for (path, a), (_, b) in zip(tree_items(got), tree_items(dict(want))):
        assert a.dtype == torch.float32, path
        _close(a.numpy(), b)
    # a bfloat16 leaf comes back in bfloat16
    xb = _bf16(tree["b"])
    got_b = tfed.weighted_average_stacked({"b": xb}, torch.from_numpy(w),
                                          use_kernel=use_kernel)["b"]
    want_b = jfed.weighted_average_stacked(
        {"b": jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)},
        jnp.asarray(w), use_kernel=use_kernel)["b"]
    assert got_b.dtype == torch.bfloat16
    _close(got_b.float().numpy(), np.asarray(want_b.astype(jnp.float32)),
           rel=BF16_ULP)


# ---------------------------------------------------------------------------
# the legacy loop, the fused round's oracle
# ---------------------------------------------------------------------------

def _close_trees(out_t, out_j):
    got = state_to_numpy(out_t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(out_j)[0]:
        sub = got
        for p in path:
            sub = sub[p.key]
        _close(sub, np.asarray(leaf))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_legacy_round_matches_reference_full_width(fed_setup, use_kernel):
    """The Table-3 widths, G and D over 3 profile groups; one cluster's
    weights sum to zero and go uniform. The reference's legacy loop runs
    its plain weighted average (its Pallas twin is held to it below)."""
    gj, gt, wrapped = fed_setup
    weights = np.asarray([0.5, 0.3, 0.2, 0.0, 0.7, 0.0])
    labels = np.asarray([0, 1, 0, 2, 1, 2])
    out_j = jfed.federate_client_params(
        gj, jax.tree_util.tree_map(jnp.asarray, wrapped), weights, labels,
        n_layers={"G": 5, "D": 5}, fused=False)
    params = state_from_numpy(wrapped, "cpu")
    out_t = tfed.federate_client_params(
        gt, params, weights, labels, n_layers={"G": 5, "D": 5},
        use_kernel=use_kernel, fused=False)
    _close_trees(out_t, out_j)
    # the input is left as it was
    again = state_from_numpy(wrapped, "cpu")
    for (_, a), (_, b) in zip(tree_items(params), tree_items(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_legacy_round_matches_reference_with_its_kernel(population,
                                                        use_kernel):
    """The synthetic 2-layer population (13 clients, 3 groups, 3
    clusters), the reference's legacy loop with and without its Pallas
    S = 1 kernel."""
    gj, gt, params, labels, weights, _ = population
    out_j = jfed.federate_client_params(
        gj, jax.tree_util.tree_map(jnp.asarray, params), weights, labels,
        n_layers={"G": 2}, use_kernel=use_kernel, fused=False)
    out_t = tfed.federate_client_params(
        gt, state_from_numpy(params, "cpu"), weights, labels,
        n_layers={"G": 2}, use_kernel=use_kernel, fused=False)
    _close_trees(out_t, out_j)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_round_matches_own_legacy_loop(fed_setup, use_kernel):
    """The port's fused flat-buffer round (one product per net) against
    its own per-(layer, cluster) loop: a clustered round, and FedAvg's
    (one cluster, weights by dataset size)."""
    gj, gt, wrapped = fed_setup
    weights = np.asarray([0.5, 0.3, 0.2, 0.0, 0.7, 0.0])
    labels = np.asarray([0, 1, 0, 2, 1, 2])
    params = state_from_numpy(wrapped, "cpu")
    sizes = np.asarray([128, 85, 128, 85, 85, 128])
    for w, lab in ((weights, labels), (sizes / sizes.sum(), labels * 0)):
        fused, legacy = (tfed.federate_client_params(
            gt, params, w, lab, n_layers={"G": 5, "D": 5},
            use_kernel=use_kernel, fused=f) for f in (True, False))
        for (pa, a), (pb, b) in zip(tree_items(fused), tree_items(legacy)):
            assert pa == pb
            _close(a.numpy(), b.numpy())


def test_legacy_round_refuses_chunks_and_cohorts(population):
    _, gt, params, labels, weights, cohort = population
    p = state_from_numpy(params, "cpu")
    for kw in (dict(chunk_size=2), dict(cohort_mask=cohort)):
        with pytest.raises(ValueError, match="fused=True"):
            tfed.federate_client_params(gt, p, weights, labels,
                                        n_layers={"G": 2}, fused=False, **kw)


# ---------------------------------------------------------------------------
# the plan's padded-stride flat buffer
# ---------------------------------------------------------------------------

def test_padded_flatten_unflatten_round_trip(fed_setup):
    """flatten lays every copy into rows padded to 32 floats (16-byte
    aligned, pad columns zero); gathering each copy's own row back gives
    its leaves bit for bit."""
    gj, gt, wrapped = fed_setup
    for net in ("G", "D"):
        tmpl = state_from_numpy({g.name: wrapped[g.name][net] for g in gj},
                                "cpu")
        plan = tfed.FederationPlan(gt, net, 5, tmpl)
        theta = plan.flatten(tmpl, torch.device("cpu"))
        assert tuple(theta.shape) == (plan.n_rows, plan.n_cols)
        assert theta.stride() == (plan.row_stride, 1)
        assert plan.row_stride % 32 == 0
        assert plan.n_cols <= plan.row_stride < plan.n_cols + 32
        full = theta.as_strided((plan.n_rows, plan.row_stride),
                                (plan.row_stride, 1))
        assert not bool(full[:, plan.n_cols:].any())
        assert plan.dense_buffer_bytes() == 4 * full.numel()
        # each copy's own row: one segment per copy
        seg_ids = torch.zeros(plan.n_copies, dtype=torch.int64)
        for e in plan.entries:
            seg_ids[e.sid0:e.sid1] = torch.arange(e.row0, e.row1)
        back = plan.unflatten(theta, seg_ids)
        for g in gt:
            for layer, tree in back[g.name].items():
                for (pa, a), (pb, b) in zip(
                        tree_items(tree), tree_items(tmpl[g.name][layer])):
                    assert pa == pb and torch.equal(a, b), (g.name, layer, pa)
