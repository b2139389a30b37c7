"""Stages 3-5 of the port against the JAX package's device twins:
clustering with injected k-means++ centres, the Eq. 13-15 weights, and
the Eq.-16 federation round (device-built weight matrix and FedAvg).

JAX's k-means++ draws from ``jax.random.categorical``, which torch
cannot reproduce, so each test computes the reference's seeding from
its own key chain and hands the centres to the port. Labels and the
selected k must be equal. Silhouettes agree to 1e-4: both sides take
distances through |x|^2 - 2 x.y + |y|^2 in float32, which loses about
|x|^2 * 6e-8 ~ 2e-5 at D = 256 to cancellation, in different orders.
Weights agree to 1e-4 relative: beta = 150 multiplies the float32 KLD
noise. Aggregated parameters are weighted sums of float32 copies, so
they agree to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as jcl  # noqa: E402
from repro.core import federation as jfed  # noqa: E402
from repro.core import kld as jkld  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import splitting as jspl  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import clustering as tcl  # noqa: E402
from repro_torch.core import federation as tfed  # noqa: E402
from repro_torch.core import kld as tkld  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import splitting as tspl  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

from test_torch_split import _population, random_split_state  # noqa: E402


def _acts(n_clusters, n=8, d=256, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1, (n_clusters, d))
    member = np.arange(n) % n_clusters
    return (centres[member] + 0.4 * rng.normal(size=(n, d))).astype(
        np.float32)


def reference_centres(acts, key, k=None):
    """The k-means++ centres ``cluster_activations_jax`` starts from:
    one [k, D] per candidate k, from the same key splits."""
    a = jnp.asarray(acts)
    z = ((a - a.mean(0)) / (a.std(0) + 1e-8)).astype(jnp.float32)
    if k is not None:
        return {k: np.asarray(jcl._kmeans_pp_init_jax(z, k, key))}
    upper = jcl.k_selection_bound(a.shape[0])
    keys = jax.random.split(key, upper - 1)
    return {kk: np.asarray(jcl._kmeans_pp_init_jax(z, kk, keys[i]))
            for i, kk in enumerate(range(2, upper + 1))}


@pytest.mark.parametrize("n_clusters,k,use_kernel",
                         [(2, None, True), (3, None, False), (3, None, True),
                          (2, 3, True)])
def test_cluster_activations_matches_reference(n_clusters, k, use_kernel):
    acts = _acts(n_clusters, seed=n_clusters)
    key = jax.random.PRNGKey(n_clusters)
    labels_j, k_j, sil_j = jax.jit(
        lambda a, kk: jcl.cluster_activations_jax(
            a, kk, k=k, use_kernel=use_kernel))(jnp.asarray(acts), key)
    centres = {kk: torch.tensor(c)
               for kk, c in reference_centres(acts, key, k).items()}
    labels_t, k_t, sil_t = tcl.cluster_activations(
        torch.from_numpy(acts), k=k, use_kernel=use_kernel,
        init_centers=centres)
    assert k_t == int(k_j)
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    assert abs(sil_t - float(sil_j)) <= 1e-4


def test_kmeans_reseeds_empty_cluster_like_reference():
    """Two identical initial centres leave one cluster empty after the
    first assignment; both sides re-seed it at the farthest point."""
    acts = _acts(3, n=9, d=32, seed=5)
    x = jnp.asarray(acts)
    init = np.stack([acts[0], acts[0], acts[4]])
    orig = jcl._kmeans_pp_init_jax
    try:
        jcl._kmeans_pp_init_jax = lambda xx, kk, key: jnp.asarray(init)
        labels_j, centres_j = jcl.kmeans_jax(x, 3, jax.random.PRNGKey(0))
    finally:
        jcl._kmeans_pp_init_jax = orig
    labels_t, centres_t = tcl.kmeans(torch.from_numpy(acts), 3,
                                     init_centers=torch.from_numpy(init))
    np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))
    np.testing.assert_allclose(centres_t.numpy(), np.asarray(centres_j),
                               rtol=1e-5, atol=1e-5)


def test_canonicalize_and_silhouette_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 16)).astype(np.float32)
    for labels in ([2, 2, 0, 1, 0, 2, 1, 1, 0], [3, 3, 3, 1, 1, 1, 1, 3, 3],
                   [0, 1, 2, 3, 0, 0, 0, 0, 0]):
        lab = np.asarray(labels, np.int32)
        want = np.asarray(jcl.canonicalize_labels_jax(jnp.asarray(lab), 4))
        got = tcl.canonicalize_labels(torch.from_numpy(lab), 4).numpy()
        np.testing.assert_array_equal(got, want)
        s_j = float(jcl.silhouette_jax(jnp.asarray(x), jnp.asarray(lab), 4))
        s_t = float(tcl.silhouette(torch.from_numpy(x), torch.from_numpy(lab),
                                   4))
        assert abs(s_t - s_j) <= 1e-4


def test_activation_weights_match_reference():
    rng = np.random.default_rng(1)
    acts = (rng.normal(size=(8, 6272)) * 0.5).astype(np.float32)
    sizes = rng.integers(60, 130, 8).astype(np.float32)
    labels = np.asarray([0, 1, 0, 2, 1, 0, 3, 1], np.int32)  # 3 is a singleton
    w_j, k_j = jkld.activation_weights_jax(
        jnp.asarray(acts), jnp.asarray(sizes), jnp.asarray(labels), 4, 150.0)
    w_t, k_t = tkld.activation_weights(
        torch.from_numpy(acts), torch.from_numpy(sizes),
        torch.from_numpy(labels), 4, 150.0)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-6)
    assert float(w_t[6]) == 1.0


@pytest.fixture(scope="module")
def fed_setup():
    """A 3-group population (6 clients) with G and D client params in
    the reference's layout."""
    gj = jspl.group_by_profile(*_population(jlat))
    gt = tspl.group_by_profile(*_population(tlat))
    params = {net: random_split_state(gj, net, seed=i)[0]
              for i, net in enumerate(("G", "D"))}
    wrapped = {g.name: {net: params[net][g.name] for net in params}
               for g in gj}
    return gj, gt, wrapped


def _compare(out_t, out_j):
    got = state_to_numpy(out_t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(out_j)[0]:
        sub = got
        for p in path:
            sub = sub[p.key]
        np.testing.assert_allclose(sub, np.asarray(leaf), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_aggregate_device_matches_reference(fed_setup, use_kernel):
    """Clustered round from device weights/labels: one cluster with
    zero total weight goes uniform over its members, like the
    reference."""
    gj, gt, wrapped = fed_setup
    weights = np.asarray([0.5, 0.3, 0.2, 0.0, 0.7, 0.0], np.float32)
    labels = np.asarray([0, 1, 0, 2, 1, 2], np.int32)
    out_j = jfed.federate_client_params_device(
        gj, jax.tree_util.tree_map(jnp.asarray, wrapped),
        jnp.asarray(weights), jnp.asarray(labels), 3,
        n_layers={"G": 5, "D": 5}, use_kernel=use_kernel, plan_cache={})
    out_t = tfed.federate_client_params_device(
        gt, state_from_numpy(wrapped, "cpu"), torch.from_numpy(weights),
        torch.from_numpy(labels), 3, n_layers={"G": 5, "D": 5},
        use_kernel=use_kernel)
    _compare(out_t, out_j)


def test_fedavg_uniform_matches_reference(fed_setup):
    gj, gt, wrapped = fed_setup
    sizes = np.asarray([128, 85, 128, 85, 85, 128])
    out_j = jfed.fedavg_uniform(gj, jax.tree_util.tree_map(jnp.asarray,
                                                           wrapped),
                                sizes, n_layers={"G": 5, "D": 5},
                                use_kernel=True, plan_cache={})
    out_t = tfed.fedavg_uniform(gt, state_from_numpy(wrapped, "cpu"), sizes,
                                n_layers={"G": 5, "D": 5}, use_kernel=True)
    _compare(out_t, out_j)


def test_weight_segments_match_reference(fed_setup):
    """The host weight matrix and the copy -> segment map are equal, and
    both plans lay out the same number of columns."""
    gj, gt, wrapped = fed_setup
    weights = np.asarray([0.5, 0.3, 0.2, 0.0, 0.7, 0.0])
    labels = np.asarray([0, 1, 0, 2, 1, 2])
    for net in ("G", "D"):
        tpl_j = {g.name: wrapped[g.name][net] for g in gj}
        pj = jfed.FederationPlan(gj, net, 5, tpl_j)
        pt = tfed.FederationPlan(gt, net, 5, state_from_numpy(tpl_j, "cpu"))
        assert (pt.n_rows, pt.n_cols, pt.n_copies) == (
            pj.n_rows, pj.n_cols, pj.n_copies)
        A_j, s_j = pj.weight_segments(weights, labels)
        A_t, s_t = pt.weight_segments(weights, labels)
        np.testing.assert_array_equal(A_t, A_j)
        np.testing.assert_array_equal(s_t, s_j)


def test_unported_round_options_raise(fed_setup):
    """Chunks and cohorts are ported (tests/test_torch_population.py), and
    so is mesh sharding: on a 1-rank mesh every entry point takes the
    unsharded round, bit for bit (sharded meshes:
    tests/test_torch_mesh.py)."""
    from repro_torch.launch.mesh import make_federation_mesh
    _, gt, wrapped = fed_setup
    params = state_from_numpy(wrapped, "cpu")
    mesh = make_federation_mesh(1, "cpu")
    weights, labels = torch.rand(6), torch.tensor([0, 1, 0, 2, 1, 2])
    for kw in ({}, {"chunk_size": 2}):
        got = tfed.fedavg_uniform(gt, params, np.arange(1, 7), mesh=mesh,
                                  **kw)
        want = tfed.fedavg_uniform(gt, params, np.arange(1, 7), **kw)
        got_d = tfed.federate_client_params_device(
            gt, params, weights, labels, 3, mesh=mesh, **kw)
        want_d = tfed.federate_client_params_device(
            gt, params, weights, labels, 3, **kw)
        for a, b in ((got, want), (got_d, want_d)):
            for (pa, x), (pb, y) in zip(tree_items(a), tree_items(b)):
                assert pa == pb and torch.equal(x, y)
