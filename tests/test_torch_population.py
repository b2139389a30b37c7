"""Population-scale training of the port against the JAX package: the
client registry, the host numpy clustering and KLD weights, cohort and
chunk-streamed federation rounds, the trainer's cohort, chunk, host and
label-KLD rounds, checkpoints and the launcher's population flags.

Inputs are made with numpy from a seed and handed to both packages;
cohorts and k-means++ centres are the reference's own draws, fed to the
port (JAX's PRNG cannot be reproduced). Tolerances:
- host numpy logic (registry churn, the numpy clustering and KLD
  copies) must be equal;
- aggregated parameters are weighted float32 sums whose order differs
  (one product, or a chunk stream re-associated over the chunks), so
  they agree to 1e-5 absolute; non-members' copies must be equal;
- device weights agree to 1e-6 absolute for given KLDs, and to 1e-4
  relative where they come from float32 activations (beta = 150
  multiplies the float32 KLD noise).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import clustering as jcl  # noqa: E402
from repro.core import federation as jfed  # noqa: E402
from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import kld as jkld  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import registry as jreg  # noqa: E402
from repro.core import splitting as jspl  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core import clustering as tcl  # noqa: E402
from repro_torch.core import federation as tfed  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import kld as tkld  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import registry as treg  # noqa: E402
from repro_torch.core import splitting as tspl  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim.optimizers import AdamState  # noqa: E402

from test_torch_fed import _acts, reference_centres  # noqa: E402

PARAM_TOL = 1e-5


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leave,join", [((), ()), ((0, 4, 9), (7, 300)),
                                        ((3,), ()), ((), (5, 6, 7))])
def test_registry_churn_matches_reference(leave, join):
    sizes = np.arange(10) * 11 + 5
    reg_j, old_j = jreg.ClientRegistry(sizes).churn(leave, join)
    reg_t, old_t = treg.ClientRegistry(sizes).churn(leave, join)
    assert old_t == old_j
    np.testing.assert_array_equal(reg_t.sizes, reg_j.sizes)
    assert reg_t.sizes.dtype == reg_j.sizes.dtype == np.int64
    for bad in (dict(leave=[10]), dict(leave=range(10))):
        with pytest.raises(ValueError):
            jreg.ClientRegistry(sizes).churn(**bad)
        with pytest.raises(ValueError):
            treg.ClientRegistry(sizes).churn(**bad)


def test_sample_cohort_and_mask():
    reg = treg.ClientRegistry.from_clients(
        tpart.build_scenario("2dom_iid", num_clients=12, base_size=8,
                             seed=0))
    assert reg.n_clients == 12
    gen = torch.Generator().manual_seed(3)
    draws = [reg.sample_cohort(gen, s) for s in (1, 5, 12)]
    for ids, s in zip(draws, (1, 5, 12)):
        assert ids.dtype == torch.int32 and ids.shape == (s,)
        assert bool((ids[1:] > ids[:-1]).all())          # sorted, unique
        assert 0 <= int(ids.min()) and int(ids.max()) < 12
    for s in (0, 13):
        with pytest.raises(ValueError, match="out of range"):
            reg.sample_cohort(gen, s)
    # the mask of injected ids equals the reference's
    reg_j = jreg.ClientRegistry(reg.sizes)
    ids_j = reg_j.sample_cohort(jax.random.PRNGKey(1), 5)
    mask_t = reg.cohort_mask(torch.tensor(np.asarray(ids_j)))
    np.testing.assert_array_equal(mask_t.numpy(),
                                  np.asarray(reg_j.cohort_mask(ids_j)))


# ---------------------------------------------------------------------------
# host numpy KLD and clustering: equal to the reference
# ---------------------------------------------------------------------------

def _kld_inputs(seed=0, n=10):
    rng = np.random.default_rng(seed)
    acts = (rng.normal(size=(n, 64)) * 0.5).astype(np.float32)
    sizes = rng.integers(60, 130, n)
    labels = np.asarray([0, 1, 0, 2, 1, 0, 3, 1, 2, 0][:n])  # 3: singleton
    cohort = np.asarray([1, 0, 1, 0, 1, 1, 1, 0, 0, 1][:n], bool)
    return acts, sizes, labels, cohort


def test_host_kld_copies_equal_reference():
    acts, sizes, labels, cohort = _kld_inputs()
    w_j, k_j = jkld.activation_weights(acts, sizes, labels, 150.0)
    w_t, k_t = tkld.activation_weights_np(acts, sizes, labels, 150.0)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(k_t, k_j)
    hists = np.random.default_rng(1).integers(0, 20, (10, 10))
    for a, b in zip(tkld.label_weights(hists, sizes, labels, 150.0),
                    jkld.label_weights(hists, sizes, labels, 150.0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tkld.cohort_federation_weights_np(k_j, sizes, labels, cohort, 3.0),
        jkld.cohort_federation_weights(k_j, sizes, labels, cohort, 3.0))
    np.testing.assert_array_equal(tkld.global_weights(k_j, sizes, 2.0),
                                  jkld.global_weights(k_j, sizes, 2.0))
    P = jkld.activation_distributions(acts)
    np.testing.assert_array_equal(tkld.activation_distributions(acts), P)
    np.testing.assert_array_equal(tkld.cluster_klds_np(P, labels),
                                  jkld.cluster_klds(P, labels))
    np.testing.assert_array_equal(
        tkld.federation_weights_np(k_j, sizes, labels, 150.0),
        jkld.federation_weights(k_j, sizes, labels, 150.0))


@pytest.mark.parametrize("n_clusters,k", [(1, None), (2, None), (3, None),
                                          (3, 3), (2, 1)])
def test_host_clustering_copy_equals_reference(n_clusters, k):
    acts = _acts(n_clusters, n=10, d=48, seed=n_clusters)
    got = tcl.cluster_activations_np(acts, k=k, seed=4)
    want = jcl.cluster_activations(acts, k=k, seed=4)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.centers, want.centers)
    assert (got.k, got.silhouette) == (want.k, want.silhouette)


def test_device_cohort_weights_match_reference():
    """Including a cluster whose cohort is empty (cluster 2) and a
    singleton cluster (3): 0 outside the cohort, never NaN."""
    acts, sizes, labels, cohort = _kld_inputs()
    klds = np.random.default_rng(2).uniform(0, 0.05, 10).astype(np.float32)
    want = jkld.cohort_federation_weights_jax(
        jnp.asarray(klds), jnp.asarray(sizes, jnp.float32),
        jnp.asarray(labels), jnp.asarray(cohort), 4, 150.0)
    got = tkld.cohort_federation_weights(
        torch.from_numpy(klds), torch.from_numpy(sizes).float(),
        torch.from_numpy(labels), torch.from_numpy(cohort), 4, 150.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert bool(torch.isfinite(got).all())
    assert float(got[~torch.from_numpy(cohort)].abs().max()) == 0.0
    assert float(got[labels == 2].abs().max()) == 0.0
    for c in (0, 1):
        sel = torch.from_numpy((labels == c) & cohort)
        assert abs(float(got[sel].sum()) - 1.0) <= 1e-6
    w_j, _ = jkld.activation_weights_jax(
        jnp.asarray(acts), jnp.asarray(sizes, jnp.float32),
        jnp.asarray(labels), 4, 150.0, cohort_mask=jnp.asarray(cohort))
    w_t, _ = tkld.activation_weights(
        torch.from_numpy(acts), torch.from_numpy(sizes).float(),
        torch.from_numpy(labels), 4, 150.0,
        cohort_mask=torch.from_numpy(cohort))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# federation rounds on a synthetic 2-layer population
# ---------------------------------------------------------------------------

# three groups of 6, 3 and 4 clients over a 2-layer net: cut (1, 2) owns
# layer 0, (2, 2) both layers, (0, 1) layer 1
POP = [(0, (1, 2, 1, 2), 6), (1, (2, 2, 2, 2), 3), (2, (0, 1, 0, 1), 4)]
N_POP = sum(n for _, _, n in POP)


def _groups(lat, spl):
    """The population's profile groups, clients shuffled across them."""
    devices, cuts = [], []
    for dev, cut, n in POP:
        devices += [lat.PAPER_DEVICES[dev]] * n
        cuts += [lat.Cut(*cut)] * n
    order = np.random.default_rng(5).permutation(N_POP)
    return spl.group_by_profile([devices[i] for i in order],
                                [cuts[i] for i in order])


@pytest.fixture(scope="module")
def population():
    gj, gt = _groups(jlat, jspl), _groups(tlat, tspl)
    rng = np.random.default_rng(0)
    params = {}
    for g in gj:
        owned = jspl.client_owned_layers((g.cut.g_h, g.cut.g_t), 2)
        params[g.name] = {"G": {str(l): {
            "w": rng.normal(size=(g.size, 5, 7)).astype(np.float32),
            "b": rng.normal(size=(g.size, 3)).astype(np.float32)}
            for l in owned}}
    labels = np.arange(N_POP) % 3
    weights = rng.random(N_POP)
    cohort = np.zeros(N_POP, bool)
    cohort[[0, 1, 3, 4, 6, 9, 10]] = True      # no member of cluster 2
    return gj, gt, params, labels, weights, cohort


def _torch_params(params):
    return state_from_numpy(params, "cpu")


def _assert_close(out_t, out_j, atol=PARAM_TOL):
    got = state_to_numpy(out_t)
    leaves = jax.tree_util.tree_flatten_with_path(out_j)[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in leaves:
        sub = got
        for p in path:
            sub = sub[p.key]
        np.testing.assert_allclose(sub, np.asarray(leaf), rtol=0, atol=atol)


@pytest.mark.parametrize("with_cohort", [False, True])
@pytest.mark.parametrize("chunk", [None, 1, 2, 3, 7])
def test_round_matches_reference(population, chunk, with_cohort):
    """Dense and chunked rounds, with and without a cohort: c = 1,
    c = 2 and 3 (each dividing some groups and leaving a tail chunk on
    the others) and c = 7 (larger than every group)."""
    gj, gt, params, labels, weights, cohort = population
    mask = cohort if with_cohort else None
    w = weights * cohort if with_cohort else weights
    out_j = jfed.federate_client_params(
        gj, jax.tree_util.tree_map(jnp.asarray, params), w, labels,
        n_layers={"G": 2}, plan_cache={}, chunk_size=chunk,
        cohort_mask=mask)
    out_t = tfed.federate_client_params(
        gt, _torch_params(params), w, labels, n_layers={"G": 2},
        use_kernel=chunk == 3, chunk_size=chunk, cohort_mask=mask)
    _assert_close(out_t, out_j)


@pytest.mark.parametrize("chunk", [None, 3])
def test_device_cohort_round_matches_reference(population, chunk):
    """Device weights with a zero-mass (layer, cluster) that has
    participants: uniform over the participants, on both sides."""
    gj, gt, params, labels, weights, cohort = population
    w = (weights * cohort * (labels != 1)).astype(np.float32)
    out_j = jfed.federate_client_params_device(
        gj, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(w),
        jnp.asarray(labels, jnp.int32), 3, n_layers={"G": 2},
        plan_cache={}, chunk_size=chunk, cohort_mask=jnp.asarray(cohort),
        cohort_size=int(cohort.sum()))
    out_t = tfed.federate_client_params_device(
        gt, _torch_params(params), torch.from_numpy(w),
        torch.from_numpy(labels), 3, n_layers={"G": 2}, chunk_size=chunk,
        cohort_mask=torch.from_numpy(cohort), cohort_size=int(cohort.sum()))
    _assert_close(out_t, out_j)


@pytest.mark.parametrize("with_cohort", [False, True])
def test_chunked_fedavg_matches_reference(population, with_cohort):
    gj, gt, params, _, _, cohort = population
    sizes = np.arange(N_POP) * 7 + 20
    mask = cohort if with_cohort else None
    out_j = jfed.fedavg_uniform(gj, jax.tree_util.tree_map(jnp.asarray,
                                                           params),
                                sizes, n_layers={"G": 2}, plan_cache={},
                                chunk_size=4, cohort_mask=mask)
    out_t = tfed.fedavg_uniform(gt, _torch_params(params), sizes,
                                n_layers={"G": 2}, chunk_size=4,
                                cohort_mask=mask)
    _assert_close(out_t, out_j)


@pytest.mark.parametrize("chunk", [None, 2])
def test_recv_select_keeps_non_members_bit_identical(population, chunk):
    gj, gt, params, labels, weights, cohort = population
    before = _torch_params(params)
    out = tfed.federate_client_params_device(
        gt, before, torch.from_numpy(weights * cohort).float(),
        torch.from_numpy(labels), 3, n_layers={"G": 2}, chunk_size=chunk,
        cohort_mask=torch.from_numpy(cohort), cohort_size=int(cohort.sum()))
    members = changed = 0
    for g in gt:
        for l, tree in before[g.name]["G"].items():
            for name, x in tree.items():
                y = out[g.name]["G"][l][name]
                for row, cid in enumerate(g.client_ids):
                    if cohort[cid]:
                        members += 1
                        changed += not torch.equal(x[row], y[row])
                    else:
                        assert torch.equal(x[row], y[row]), (g.name, cid)
    # a member alone in its (layer, cluster ∩ cohort) gets itself back
    assert 0 < changed <= members


def test_buffer_bytes_equal_reference(population):
    """The reference counts D = n_cols columns per row; the port
    allocates its rows padded to ``row_stride`` (a multiple of 32 floats
    that holds n_cols) and reports the bytes it allocates: the
    reference's count with D = row_stride."""
    gj, gt, params, _, _, _ = population
    tmpl_j = {g.name: params[g.name]["G"] for g in gj}
    tmpl_t = _torch_params(tmpl_j)
    for chunk in (1, 3, 64):
        pj = jfed.FederationPlan(gj, "G", 2, tmpl_j, chunk_size=chunk)
        pt = tfed.FederationPlan(gt, "G", 2, tmpl_t, chunk_size=chunk)
        ld = pt.row_stride
        assert pt.n_cols == pj.n_cols <= ld < pj.n_cols + 32 and ld % 32 == 0
        assert pj.dense_buffer_bytes() == 4 * pj.n_rows * pj.n_cols
        assert pt.dense_buffer_bytes() == pj.dense_buffer_bytes() // pj.n_cols * ld
        for C in (1, 3, 6):
            S = pt.num_segments(C)
            assert pj.chunked_buffer_bytes(C) == 4 * (
                chunk * pj.n_cols + S * chunk + S * pj.n_cols + S)
            assert pt.chunked_buffer_bytes(C) == 4 * (
                chunk * ld + S * chunk + S * ld + S)
    with pytest.raises(ValueError, match="chunk_size"):
        tfed.FederationPlan(gt, "G", 2, tmpl_t).chunked_buffer_bytes(2)


def test_mesh_still_raises(population):
    """Mesh sharding is ported (tests/test_torch_mesh.py); a mesh that is
    not a ``DeviceMesh`` is a caller's error."""
    _, gt, params, labels, weights, _ = population
    with pytest.raises(TypeError, match="DeviceMesh"):
        tfed.federate_client_params(gt, _torch_params(params), weights,
                                    labels, n_layers={"G": 2}, mesh=object())


# ---------------------------------------------------------------------------
# the trainer's population rounds, against the reference trainer
# ---------------------------------------------------------------------------

_INIT = {}


def _trainer_pair(**cfg):
    """The reference and the port on one 8-client Table-3 population (two
    profile groups of 4) from the reference's initial state, with one
    middle-activation EMA in both (the rounds read nothing else of the
    training)."""
    def setup(lat, part):
        clients = part.build_scenario("2dom_noniid", num_clients=8,
                                      base_size=16, seed=0)
        devices = [lat.PAPER_DEVICES[i % 2] for i in range(8)]
        cuts = [lat.Cut(1, 3, 1, 3) if i % 2 else lat.Cut(2, 4, 2, 4)
                for i in range(8)]
        return clients, devices, cuts
    cfg = dict(batch=2, seed=0, **cfg)
    init = jhuscf.HuSCFTrainer._init_state
    with pytest.MonkeyPatch.context() as mp:
        # one traced initializer for every pair (same groups, same draws)
        mp.setattr(jhuscf.HuSCFTrainer, "_init_state",
                   lambda self, k: _INIT.setdefault(
                       "state", jax.jit(lambda kk: init(self, kk))(k)))
        ref = jhuscf.HuSCFTrainer(*setup(jlat, jpart),
                                  config=jhuscf.HuSCFConfig(**cfg))
    port = thuscf.HuSCFTrainer(*setup(tlat, tpart),
                               config=thuscf.HuSCFConfig(**cfg),
                               device="cpu")
    port.state = state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                         ref.state), "cpu")
    acts = _acts(2, n=8, d=6272, seed=9)
    ref._mid_ema, ref._trained = jnp.asarray(acts), True
    ref._ema_init = jnp.asarray(True)
    port._mid_ema, port._ema_init = torch.from_numpy(acts), True
    return ref, port


def _round(ref, port, **kw):
    """One federate() on both, the port given the reference's cohort and
    k-means++ draws; returns both diagnostics."""
    ids = centres = None
    if ref.cfg.cohort_size is not None:
        _, sub = jax.random.split(ref._cohort_key)
        ids = torch.tensor(np.asarray(
            ref.registry.sample_cohort(sub, ref.cfg.cohort_size)))
    if ref.fed_round >= ref.cfg.warmup_fed_rounds and ref.cfg.fused_cluster \
            and not kw.get("use_label_kld"):
        _, sub = jax.random.split(ref._cluster_key)
        centres = {k: torch.tensor(c) for k, c in reference_centres(
            np.asarray(ref._mid_ema), sub).items()}
    d_ref = ref.federate(**kw)
    d_port = port.federate(init_centers=centres, cohort_ids=ids, **kw)
    if ids is not None:
        np.testing.assert_array_equal(d_port["cohort"].numpy(),
                                      np.asarray(d_ref["cohort"]))
    for net in ("G", "D"):
        _assert_close(port.state[net]["client"],
                      jax.tree_util.tree_map(np.asarray,
                                             ref.state[net]["client"]))
    return d_ref, d_port


def _check_clustered(d_ref, d_port, exact):
    assert d_port["mode"] == d_ref["mode"] == "clustered"
    assert d_port["k"] == int(d_ref["k"])
    lab = np.asarray(d_port["labels"])
    np.testing.assert_array_equal(lab, np.asarray(d_ref["labels"]))
    w_t, w_j = np.asarray(d_port["weights"]), np.asarray(d_ref["weights"])
    if exact:
        np.testing.assert_array_equal(w_t, w_j)
        assert d_port["silhouette"] == d_ref["silhouette"]
    else:
        np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-6)


def test_trainer_cohort_chunk_rounds_match_reference():
    """A chunked cohort FedAvg warm-up round, then a chunked cohort
    clustered round on the device (chunk 3 over groups of 4: a tail)."""
    ref, port = _trainer_pair(cohort_size=5, agg_chunk=3,
                              warmup_fed_rounds=1)
    d_ref, d_port = _round(ref, port)
    assert d_port["mode"] == d_ref["mode"] == "fedavg"
    d_ref, d_port = _round(ref, port)
    _check_clustered(d_ref, d_port, exact=False)
    w, cohort = d_port["weights"], np.asarray(d_port["cohort"])
    outside = np.setdiff1d(np.arange(8), cohort)
    assert float(w[torch.from_numpy(outside)].abs().max()) == 0.0
    with pytest.raises(ValueError, match="out of range"):
        thuscf.HuSCFTrainer(port.clients, port.devices, cuts=port.cuts,
                            config=thuscf.HuSCFConfig(cohort_size=9),
                            device="cpu")


def test_trainer_host_round_matches_reference():
    """fused_cluster=False: the numpy clustering and weights are equal,
    then a dense cohort round."""
    ref, port = _trainer_pair(cohort_size=6, fused_cluster=False,
                              warmup_fed_rounds=0)
    _check_clustered(*_round(ref, port), exact=True)


def test_trainer_label_kld_round_matches_reference():
    """The FeGAN-style label-histogram KLD round, chunked."""
    ref, port = _trainer_pair(agg_chunk=2, warmup_fed_rounds=0)
    d_ref, d_port = _round(ref, port, use_label_kld=True)
    _check_clustered(d_ref, d_port, exact=True)
    w, lab = d_port["weights"], d_port["labels"]
    for c in np.unique(lab):
        assert abs(w[lab == c].sum() - 1.0) <= 1e-12


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"b": {"x": rng.normal(size=(3, 2)).astype(np.float32),
                  "a": np.arange(5, dtype=np.int32)},
            "opt": AdamState(np.int32(7),
                             {"w": rng.normal(size=(300,)).astype(np.float32)},
                             {"w": np.zeros(300, np.float32)}),
            "step": np.int32(-40000), "big": np.ones((70000,), np.float32),
            "k" * 40: np.float32(2.5)}


def test_checkpoint_round_trip_and_mismatch(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    path = str(tmp_path / "sub" / "a.ckpt")
    tckpt.save_checkpoint(path, tree, step=300)
    back, step = tckpt.load_checkpoint(path, tree)
    assert step == 300 and isinstance(back["opt"], AdamState)
    for a, b in zip(tckpt.tree_flatten(back)[0], tckpt.tree_flatten(tree)[0]):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    bad_shape = dict(tree, step=np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(path, bad_shape)
    with pytest.raises(ValueError, match="treedef"):
        tckpt.load_checkpoint(path, dict(tree, extra=np.zeros(1)))
    with pytest.raises(ValueError, match="treedef"):
        tckpt.load_checkpoint(path, {k: v for k, v in tree.items()
                                     if k != "b"})


def test_checkpoint_file_is_msgpack_with_reference_leaves(tmp_path):
    """The port's encoder writes msgpack's own bytes, and the file decodes
    with msgpack and the reference's ``_unpack_leaf`` into the leaves
    JAX flattens the tree into."""
    tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "b.ckpt")
    tckpt.save_checkpoint(path, tree, step=70000)
    data = open(path, "rb").read()
    payload = msgpack.unpackb(data, raw=False)
    assert data == msgpack.packb(payload, use_bin_type=True)
    assert tckpt.unpackb(data) == payload and payload["step"] == 70000
    want = jax.tree_util.tree_leaves(tree)
    got = [jckpt._unpack_leaf(d) for d in payload["leaves"]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    for v in (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1,
              -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
              -2 ** 63, "", "x" * 31, "y" * 32, "z" * 70000, b"", b"q" * 300,
              list(range(16)), {str(i): i for i in range(20)}):
        assert tckpt.packb(v) == msgpack.packb(v, use_bin_type=True), v
        assert tckpt.unpackb(tckpt.packb(v)) == v


def test_trainer_checkpoint_holds_reference_leaves(tmp_path):
    """A trainer's state carried over from the reference and written by
    the port decodes into the reference's own leaves, bit for bit."""
    ref, port = _trainer_pair()
    path = str(tmp_path / "t.ckpt")
    tckpt.save_checkpoint(path, state_to_numpy(port.state), step=3)
    payload = msgpack.unpackb(open(path, "rb").read(), raw=False)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            ref.state))
    got = [jckpt._unpack_leaf(d) for d in payload["leaves"]]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    back, _ = tckpt.load_checkpoint(path, state_to_numpy(port.state))
    restored = state_from_numpy(back, "cpu")
    for a, b in zip(tckpt.tree_flatten(restored)[0],
                    tckpt.tree_flatten(port.state)[0]):
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_population_flags_on_cpu(tmp_path, capsys):
    path = str(tmp_path / "t.ckpt")
    tr = ttrain.main(["--arch", "huscf-gan", "--device", "cpu", "--clients",
                      "8", "--base-size", "12", "--batch", "4", "--epochs",
                      "3", "--federate-every", "1", "--cohort", "4",
                      "--agg-chunk", "3", "--ckpt", path])
    out = capsys.readouterr().out
    assert "chunked(3) aggregation, cohort 4/8" in out
    assert f"[train] checkpoint -> {path}" in out
    assert [d["mode"] for d in tr.fed_log] == ["fedavg", "fedavg",
                                               "clustered"]
    assert all(len(d["cohort"]) == 4 for d in tr.fed_log)
    back, step = tckpt.load_checkpoint(path, state_to_numpy(tr.state))
    assert step == 3


@pytest.mark.parametrize("flag,item", [
    ("--fed-devices", r"--fed-devices {n} .* the {have} visible GPU")])
def test_launcher_unported_flags_raise(flag, item):
    """``--fed-devices`` is ported (tests/test_torch_mesh.py); on ``cuda``
    it takes one rank per visible GPU, so more ranks than GPUs (2 against
    none here) raise, naming both counts."""
    have = torch.cuda.device_count()
    n = max(2, have + 1)
    with pytest.raises(ValueError, match=item.format(n=n, have=have)):
        ttrain.main(["--arch", "huscf-gan", "--device", "cuda", flag, str(n)])
