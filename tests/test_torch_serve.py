"""The port's split serving (``repro_torch.launch.serve_split``) against
the JAX package's, on the CPU: the LM's layers, the U-shaped LM engine,
the GAN engine on both profile mixes, its analytic latency, and the
trainer's ``generate``.

Weights come from one side's initialisers and are carried to the other
with ``repro_torch.bridge``; requests, prompts and labels are made with
numpy from a seed and handed to both.

Tolerances: RoPE, RMSNorm and GELU are a few float32 operations on
values of order 1 and agree to 1e-6. The LM's logits pass four blocks
of float32 products whose sums run in another order on each side; the
reference's own engine-vs-oracle test allows 2e-4, and so does this.
The GAN engine's images go through five layers of float32 convolutions
(1e-4, the port's forward tolerance). The analytic latency is host
float64 arithmetic in the same order: 1e-12.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import splitting as jsplit  # noqa: E402
from repro.launch import serve_split as jss  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro_torch.bridge import (split_lm_from_numpy, state_from_numpy,  # noqa: E402
                                state_to_numpy)
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.launch import serve_split as tss  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import gan as tgan  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402

MIXES = ("edge-heavy", "balanced")
LM_TOL = 2e-4
GAN_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos_shape", ["S", "BS"])
def test_rope_matches_reference(pos_shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = (np.arange(7) + 5 if pos_shape == "S"
           else rng.integers(0, 200, (2, 7))).astype(np.int32)
    want = np.asarray(jA.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    got = tA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_rmsnorm_gelu_linear_match_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 24)) * 2).astype(np.float32)
    scale = rng.normal(size=(24,)).astype(np.float32)
    want = np.asarray(jnn.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                        jnp.asarray(x)))
    got = tnn.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # jax.nn.gelu defaults to the tanh approximation, PyTorch's to erf
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tnn.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert np.abs(got - torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
                  ).max() > 1e-5
    p = _np(jnn.dense_init(jax.random.PRNGKey(0), 24, 8))
    p["b"] = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(jnn.dense_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                      jnp.asarray(x)))
    got = tnn.linear_apply({k: torch.tensor(v) for k, v in p.items()},
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# LM engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    cfg = jss.SplitLMConfig(s_max=48)
    jparams = jss.init_split_lm(jax.random.PRNGKey(3), cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20)
                                             ).astype(np.int32)
    P = 12
    want = np.asarray(jax.jit(lambda p, t: jss.split_lm_decode_logits(
        cfg, p, t, P))(jparams, jnp.asarray(toks)))
    oracle = np.asarray(jax.jit(lambda p, t: jss.lm_reference_logits(
        cfg, p, t))(jparams, jnp.asarray(toks)))
    tcfg = tss.SplitLMConfig(s_max=48)
    return tcfg, split_lm_from_numpy(_np(jparams), "cpu"), toks, P, want, oracle


def test_split_lm_decode_logits_match_reference(lm):
    cfg, params, toks, P, want, oracle = lm
    got = tss.split_lm_decode_logits(cfg, params, torch.from_numpy(toks), P)
    assert tuple(got.shape) == want.shape == (2, toks.shape[1] - P, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=LM_TOL, rtol=LM_TOL)
    dense = tss.lm_reference_logits(cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(dense.numpy(), oracle, atol=LM_TOL,
                               rtol=LM_TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy()[:, P - 1:-1],
                               atol=LM_TOL, rtol=LM_TOL)


def test_split_lm_generate_greedy_consistency(lm):
    """Greedy generation replays the teacher-forced logits: each token is
    the argmax of the decode logits fed its own prefix."""
    cfg, params, toks, _, _, _ = lm
    prompt = torch.from_numpy(toks[:, :10])
    gen = tss.split_lm_generate(cfg, params, prompt, 8)
    assert gen.dtype == torch.int32 and tuple(gen.shape) == (2, 8)
    full = torch.cat([prompt, gen], 1)
    logits = tss.split_lm_decode_logits(cfg, params, full, 10)
    assert torch.equal(gen, torch.argmax(logits, -1).to(torch.int32))


def test_split_lm_init_layout_matches_reference():
    cfg = tss.SplitLMConfig()
    ours = tss.init_split_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    theirs = _np(jss.init_split_lm(jax.random.PRNGKey(0), jss.SplitLMConfig()))
    assert len(ours["blocks"]) == len(theirs["blocks"]) == cfg.n_layers
    flat_o = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), ours))
    flat_t = jax.tree_util.tree_leaves_with_path(theirs)
    assert [(jax.tree_util.keystr(p), a.shape) for p, a in flat_o] == \
        [(jax.tree_util.keystr(p), a.shape) for p, a in flat_t]


# ---------------------------------------------------------------------------
# GAN engine
# ---------------------------------------------------------------------------

def _requests(mod, groups, n, seed):
    rng = np.random.default_rng(seed)
    n_clients = sum(g.size for g in groups)
    return [mod.ServeRequest(int(rng.integers(0, n_clients)),
                             rng.normal(0, 1, tgan.Z_DIM).astype(np.float32),
                             int(rng.integers(0, tgan.NUM_CLASSES)))
            for _ in range(n)]


@pytest.fixture(scope="module", params=MIXES)
def engines(request):
    """The reference's engine and the port's on one random state, drawn
    by the port and carried to the reference's layout."""
    mix = request.param
    tgroups = tss.build_mix(mix)
    client, server = tss.init_gan_serving_state(
        torch.Generator().manual_seed(0), tgroups, device="cpu")
    _randomize_bn_stats((client, server), seed=1)
    teng = tss.SplitGanEngine(tgroups, client, server)
    jeng = jss.SplitGanEngine(jss.build_mix(mix),
                              _jnp(state_to_numpy(client)),
                              _jnp(state_to_numpy(server)))
    return jeng, teng


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _randomize_bn_stats(trees, seed):
    """Trained-looking BatchNorm running statistics, so that eval-mode
    BatchNorm is not the identity."""
    gen = torch.Generator().manual_seed(seed)

    def visit(tree):
        for k, v in tree.items():
            if k == "bn":
                v["mean"] = torch.randn(v["mean"].shape, generator=gen) * 0.1
                v["var"] = torch.rand(v["var"].shape, generator=gen) + 0.5
            elif isinstance(v, dict):
                visit(v)
    for tree in trees:
        visit(tree)


def test_gan_engine_matches_reference(engines):
    jeng, teng = engines
    reqs = _requests(tss, teng.groups, 11, seed=3)
    got = teng.serve(reqs)
    want = np.asarray(jeng.serve(_requests(jss, jeng.groups, 11, seed=3)))
    assert got.shape == want.shape == (11, 28, 28, 1)
    np.testing.assert_allclose(got, want, atol=GAN_TOL, rtol=GAN_TOL)
    assert teng.plan(reqs)[:2] == jeng.plan(reqs)[:2]


def test_gan_predict_latency_matches_reference(engines):
    jeng, teng = engines
    for n, seed in ((9, 0), (24, 1), (3, 2)):
        reqs = _requests(tss, teng.groups, n, seed)
        for padded in (True, False):
            got = teng.predict_latency(reqs, padded=padded)
            want = jeng.predict_latency(reqs, padded=padded)
            assert got == pytest.approx(want, rel=1e-12, abs=0)
        active = teng.plan(reqs)[0]
        ours, theirs = teng.program_for(active), jeng.program_for(active)
        for prog in (ours, theirs):
            assert prog.group_names == active
        assert [(s.layer, s.active, s.joins, s.departs) for s in ours.steps] \
            == [(s.layer, s.active, s.joins, s.departs) for s in theirs.steps]
        assert ([(s.gname, s.start, s.stop) for s in ours.heads + ours.tails]
                == [(s.gname, s.start, s.stop)
                    for s in theirs.heads + theirs.tails])


def test_gan_padding_rows_cannot_touch_valid_rows(engines):
    """Eval-mode BatchNorm uses the running statistics per element: a
    request's image does not depend on what else is in its bucket."""
    _, eng = engines
    reqs = _requests(tss, eng.groups, 7, seed=4)
    full = eng.serve(reqs)
    for i in (0, 6):
        alone = eng.serve([reqs[i]])
        np.testing.assert_allclose(alone[0], full[i], atol=1e-5, rtol=1e-5)


def test_gan_subset_cohort_drops_absent_cuts():
    groups = tss.build_mix("balanced")
    client, server = tss.init_gan_serving_state(
        torch.Generator().manual_seed(0), groups, device="cpu")
    eng = tss.SplitGanEngine(groups, client, server)
    g0 = groups[0]
    req = tss.ServeRequest(g0.client_ids[0], np.zeros(tgan.Z_DIM, np.float32),
                           7)
    active, buckets, _ = eng.plan([req])
    assert active == (g0.name,) and buckets == (1,)
    program = eng.program_for(active)
    assert program.group_names == (g0.name,)
    assert program.server_span() == tuple(range(g0.cut.g_h, g0.cut.g_t))
    assert eng.serve([req]).shape == (1, 28, 28, 1)


def test_gan_engine_mesh_is_not_ported():
    """Sharded serving is ported (tests/test_torch_mesh.py): on a 1-rank
    mesh no bucket shards, and the engine serves what ``mesh=None``
    serves, bit for bit."""
    from repro_torch.launch.mesh import make_federation_mesh
    groups = tss.build_mix("balanced")
    client, server = tss.init_gan_serving_state(
        torch.Generator().manual_seed(0), groups, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [tss.ServeRequest(g.client_ids[j % g.size],
                             rng.normal(size=tgan.Z_DIM).astype(np.float32),
                             int(rng.integers(0, 10)))
            for g, n in zip(groups, (3, 4, 1, 2)) for j in range(n)]
    eng = tss.SplitGanEngine(groups, client, server,
                             mesh=make_federation_mesh(1, "cpu"))
    _, buckets, _ = eng.plan(reqs)
    assert eng.shard_axes(buckets) is None
    want = tss.SplitGanEngine(groups, client, server).serve(reqs)
    assert np.array_equal(eng.serve(reqs), want)


# ---------------------------------------------------------------------------
# generate (M8a)
# ---------------------------------------------------------------------------

def test_generate_matches_reference():
    """The port's trainer and the reference's ``generate`` on one state:
    the reference's method runs on a stand-in holding what it reads
    (config, groups, state and the numpy generator seeded as its trainer
    seeds it), so no reference trainer is built."""
    clients = tpart.build_scenario("2dom_iid", num_clients=4, base_size=16,
                                   seed=0)[:3]
    devices = [tlat.PAPER_DEVICES[0], tlat.PAPER_DEVICES[1],
               tlat.PAPER_DEVICES[0]]
    cuts = [tlat.Cut(1, 3, 1, 3), tlat.Cut(2, 4, 2, 4), tlat.Cut(1, 3, 1, 3)]
    seed = 4
    tt = thuscf.HuSCFTrainer(clients, devices, cuts=cuts,
                             config=thuscf.HuSCFConfig(batch=2, seed=seed),
                             device="cpu")
    _randomize_bn_stats([tt.state["G"]], seed=2)
    jgroups = jsplit.group_by_profile(
        [jlat.PAPER_DEVICES[0], jlat.PAPER_DEVICES[1], jlat.PAPER_DEVICES[0]],
        [jlat.Cut(*c.as_tuple()) for c in cuts])
    ref_self = types.SimpleNamespace(
        cfg=jhuscf.HuSCFConfig(batch=2, seed=seed), groups=jgroups,
        state={"G": _jnp(state_to_numpy(tt.state["G"]))}, _gen_fn=None,
        _rng=np.random.default_rng(seed + 1))
    labels = np.random.default_rng(1).integers(0, 10, 11).astype(np.int32)
    want_imgs, want_labs = jhuscf.HuSCFTrainer.generate(ref_self, 2, labels)
    got_imgs, got_labs = tt.generate(2, labels)
    assert got_imgs.shape == want_imgs.shape == (11, 28, 28, 1)
    np.testing.assert_array_equal(got_labs, want_labs)
    np.testing.assert_allclose(got_imgs, want_imgs, atol=GAN_TOL,
                               rtol=GAN_TOL)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_runs_on_cpu_and_prints_the_reference_lines(capsys):
    out = tss.main(["--mode", "lm", "--device", "cpu", "--prompt-len", "8",
                    "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    out = tss.main(["--mode", "gan", "--device", "cpu", "--mix", "balanced",
                    "--requests", "3", "--iters", "1"])
    assert out["images"].shape == (3, 28, 28, 1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve_split] lm decode 2x4 ")
    assert lines[1].startswith("[serve_split] sample continuation (seq 0): ")
    assert lines[2].startswith("[serve_split] mix=balanced requests=3 ")
    assert lines[3].startswith("[serve_split] images=(3, 28, 28, 1) ")


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tss.main(["--mode", "lm"])


def test_serving_constructors_default_to_cuda():
    """Weights built or converted without naming a device go to the
    card, or the call raises: the engines run wherever their weights
    are."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tss.init_split_lm(gen, tss.SplitLMConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tss.init_gan_serving_state(gen, tss.build_mix("balanced"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        split_lm_from_numpy({"embed": np.zeros((4, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"b": np.zeros(3, np.float32)})
