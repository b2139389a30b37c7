"""The port's legacy split executor and no-concat server schedule, and
the public names the port took over from the reference in the same
slice, on the CPU against the JAX package.

* ``core.huscf.build_net_apply_legacy`` against the reference's, for G
  and D, ``concat_groups`` True and False, train True and False:
  outputs within 1e-4, captured middles and every updated parameter
  (BatchNorm statistics included) within 1e-5, the tolerances of
  ``tests/test_torch_split.py``.
* The legacy executor against the port's ``segments.make_apply`` over
  the same grid, bit for bit (the twin of
  ``tests/test_segments.py::test_make_apply_bitexact_vs_legacy``).
* Trainers with ``split_program=False`` against ``True``, bit for bit
  after a step and a federation round, on fused epochs (through the
  stand-in graph pool of ``tests/test_torch_fused_epoch.py``) and on
  the step loop.
* ``chunked_attention`` over ``k_chunk``, the 2-D convolutions over
  their padding forms, the initialisers' ``use_bias``/``dtype``,
  ``fedavg_uniform(fused=False)``, the cut ranges and ``stack_params``,
  ``baselines.common.merge_bn`` and ``bridge`` on bias-free leaves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.baselines import common as jcommon  # noqa: E402
from repro.core import federation as jfed  # noqa: E402
from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import splitting as jspl  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import classifier as jcls  # noqa: E402
from repro.models import gan as jgan  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro_torch.baselines import common as tcommon  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import federation as tfed  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.core import splitting as tspl  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import classifier as tcls  # noqa: E402
from repro_torch.models import gan as tgan  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.tree import tree_items, tree_leaves, tree_map  # noqa: E402

from test_torch_fused_epoch import FakePool  # noqa: E402
from test_torch_split import _population, random_split_state  # noqa: E402

GRID = [(net, concat, train) for net in ("G", "D")
        for concat in (True, False) for train in (True, False)]


def _inputs(groups, net, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for g in groups:
        y = rng.integers(0, 10, (g.size, batch)).astype(np.int32)
        first = ((g.size, batch, 100) if net == "G"
                 else (g.size, batch, 28, 28, 1))
        out[g.name] = (rng.normal(size=first).astype(np.float32), y)
    return out


@pytest.fixture(scope="module")
def split_case():
    """Per net: the reference's and the port's groups, one random state
    in the reference's layout, and inputs."""
    dj, cj = _population(jlat)
    dt, ct = _population(tlat)
    gj, gt = jspl.group_by_profile(dj, cj), tspl.group_by_profile(dt, ct)
    return {net: (gj, gt, random_split_state(gj, net, seed=0),
                  _inputs(gj, net)) for net in ("G", "D")}


def _port_run(apply, state, inputs, train):
    client, server = state
    return apply(state_from_numpy(client, "cpu"),
                 state_from_numpy(server, "cpu"),
                 {k: tuple(map(torch.from_numpy, v))
                  for k, v in inputs.items()}, train)


@pytest.mark.parametrize("net,concat,train", GRID)
def test_legacy_executor_matches_reference(split_case, net, concat, train):
    gj, gt, state, inputs = split_case[net]
    capture = net == "D"
    out_j, nc_j, ns_j, mid_j = jax.jit(jhuscf.build_net_apply_legacy(
        gj, net, capture_middle=capture, concat_groups=concat),
        static_argnums=3)(*state, {k: tuple(map(jnp.asarray, v))
                                   for k, v in inputs.items()}, train)
    out_t, nc_t, ns_t, mid_t = _port_run(thuscf.build_net_apply_legacy(
        gt, net, capture_middle=capture, concat_groups=concat), state,
        inputs, train)
    for g in gj:
        np.testing.assert_allclose(out_t[g.name].numpy(),
                                   np.asarray(out_j[g.name]), rtol=1e-4,
                                   atol=1e-4)
    assert set(mid_t) == set(mid_j)
    for name in mid_j:
        np.testing.assert_allclose(mid_t[name].numpy(),
                                   np.asarray(mid_j[name]), rtol=1e-5,
                                   atol=1e-5)
    for got, want in ((state_to_numpy(nc_t), nc_j),
                      (state_to_numpy(ns_t), ns_j)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            sub = got
            for p in path:
                sub = sub[p.key]
            np.testing.assert_allclose(sub, np.asarray(leaf), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("net,concat,train", GRID)
def test_program_executor_bitexact_vs_legacy(split_case, net, concat,
                                             train):
    _, gt, state, inputs = split_case[net]
    capture = net == "D"
    new = _port_run(thuscf.build_net_apply(
        gt, net, capture_middle=capture, concat_groups=concat), state,
        inputs, train)
    old = _port_run(thuscf.build_net_apply_legacy(
        gt, net, capture_middle=capture, concat_groups=concat), state,
        inputs, train)
    a, b = (list(tree_items(dict(enumerate(r)))) for r in (new, old))
    assert [p for p, _ in a] == [p for p, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_no_concat_keeps_per_group_statistics(split_case):
    """The no-concat schedule's server statistics are the equal-weight
    mean of per-group passes: they differ from the concat schedule's,
    and a server layer that only one group uses agrees with it."""
    _, gt, state, inputs = split_case["D"]
    prog = tseg.compile_split_program(gt, "D")
    _, _, ns_c, _ = _port_run(tseg.make_apply(prog), state, inputs, True)
    _, _, ns_g, _ = _port_run(tseg.make_apply(prog, concat_groups=False),
                              state, inputs, True)
    for step in prog.steps:
        a, b = ns_c[str(step.layer)], ns_g[str(step.layer)]
        same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
        assert same == (len(step.active) == 1), step


def _trainer(split_program: bool, fused: bool):
    clients = tpart.build_scenario("2dom_iid", num_clients=4, base_size=16,
                                   seed=0)
    devices = [tlat.PAPER_DEVICES[i % 2] for i in range(4)]
    cuts = [tlat.Cut(1, 4, 1, 4) if i % 2 == 0 else tlat.Cut(2, 3, 2, 3)
            for i in range(4)]
    tr = thuscf.HuSCFTrainer(
        clients, devices, cuts=cuts, device="cpu",
        config=thuscf.HuSCFConfig(batch=2, federate_every=1, seed=0,
                                  steps_per_epoch=1, warmup_fed_rounds=0,
                                  split_program=split_program,
                                  fused_epoch=fused))
    if fused:
        tr._graph_pool = FakePool()
    return tr


@pytest.fixture(scope="module")
def trained():
    """Per (split_program, epochs): the state's G and D leaves, the EMA
    and the last losses after two steps, a clustered federation round
    and two more steps. On fused epochs (the stand-in graph pool) the
    first step is the eager warm-up and the others replay one captured
    graph, the last two after the round replaced the client leaves."""
    out = {}
    for flag in (True, False):
        for fused in (True, False):
            tr = _trainer(flag, fused)
            tr.train_steps(2)
            assert tr.federate()["mode"] == "clustered"
            losses = tr.train_steps(2)
            if fused:
                assert len(tr._graph_pool.captures) == 1
            out[flag, fused] = (list(tree_items({"G": tr.state["G"],
                                                 "D": tr.state["D"]})),
                                tr._mid_ema, losses)
    return out


def _same_run(a, b) -> bool:
    (la, ea, ma), (lb, eb, mb) = a, b
    return ([p for p, _ in la] == [p for p, _ in lb]
            and all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
            and torch.equal(ea, eb) and ma == mb)


@pytest.mark.parametrize("fused", [True, False])
def test_trainer_split_program_flag_bitexact(trained, fused):
    """The twin of ``tests/test_segments.py::
    test_trainer_split_program_flag_bitexact``, on fused epochs and on
    the step loop."""
    assert _same_run(trained[True, fused], trained[False, fused])


@pytest.mark.parametrize("split_program", [True, False])
def test_replayed_epochs_after_a_round_match_the_step_loop(trained,
                                                           split_program):
    """A graph captured before a federation round trains the carry the
    round's leaves were copied into, as the step loop trains them."""
    assert _same_run(trained[split_program, True],
                     trained[split_program, False])


# ---------------------------------------------------------------------------
# the public API the port took over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,qc,kc", [(16, 16, 16), (37, 8, 16),
                                     (64, 16, 8), (40, 16, 7)])
@pytest.mark.parametrize("window,causal", [(None, True), (8, True),
                                           (None, False)])
def test_chunked_attention_k_chunk_matches_reference(S, qc, kc, window,
                                                     causal):
    rng = np.random.default_rng(S)
    B, H, KV, hd = 2, 4, 2, 16
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    kw = dict(window=window, q_chunk=qc, k_chunk=kc, causal=causal)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_chunked_attention_one_key_chunk_is_the_one_pass_path():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 24, 4, 8), (1, 24, 2, 8), (1, 24, 2, 8)))
    for window in (None, 5):
        a = tattn.chunked_attention(q, k, v, window=window, q_chunk=8,
                                    k_chunk=24)
        b = tattn.chunked_attention(q, k, v, window=window, q_chunk=8,
                                    k_chunk=512)
        assert torch.equal(a, b)


PADS = ["SAME", "VALID", ((1, 2), (0, 1)), ((-1, 0), (2, 1)),
        ((5, 4), (0, 6))]


@pytest.mark.parametrize("kind", ["conv", "convt"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", PADS, ids=str)
@pytest.mark.parametrize("bias", [True, False])
def test_conv_padding_forms_match_reference(kind, stride, padding, bias):
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 9, 8, 3)).astype(np.float32)
    p = {"w": (rng.normal(size=(4, 4, 3, 5)) / np.sqrt(48)
               ).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(0, 0.1, 5).astype(np.float32)
    jf, tf = ((jnn.conv2d_apply, tnn.conv2d_apply) if kind == "conv"
              else (jnn.convT2d_apply, tnn.convT2d_apply))
    want = np.asarray(jf({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), stride=stride, padding=padding))
    pt = state_from_numpy({kind: {k: v[None] for k, v in p.items()}},
                          "cpu")[kind]
    got = tf(pt, torch.from_numpy(x)[None], stride=stride,
             padding=padding)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def _shapes_dtypes(tree):
    """(shape, dtype name) of every leaf: arrays or ``jax.eval_shape``'s
    abstract values."""
    return [(tuple(x.shape), str(x.dtype))
            for x in jax.tree_util.tree_leaves(tree)]


def _port_shapes_dtypes(layer):
    """A port layer of one copy: its leaves' shapes in the reference's
    layout (without the copy axis) and their dtypes."""
    ref = state_to_numpy({"l": tree_map(lambda x: x[0].float(), layer)})
    return [(tuple(np.shape(a)), str(x.dtype).replace("torch.", ""))
            for a, x in zip(jax.tree_util.tree_leaves(ref),
                            tree_leaves(layer))]


@pytest.mark.parametrize("use_bias", [True, False])
def test_initialisers_take_use_bias_and_dtype(use_bias):
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for jinit, tinit, args in (
            (jnn.dense_init, tnn.dense_init, (6, 5)),
            (jnn.conv2d_init, tnn.conv2d_init, (3, 5, 4)),
            (jnn.convT2d_init, tnn.convT2d_init, (3, 5, 4))):
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
            want = jax.eval_shape(lambda k: jinit(
                k, *args, use_bias=use_bias, dtype=jd), key)
            got = tinit(1, *args, gen, "cpu", use_bias=use_bias, dtype=td)
            assert sorted(got) == sorted(want)
            assert all(got[k].dtype == td and got[k].shape[0] == 1
                       for k in got)
            assert got["w"].numel() == np.prod(want["w"].shape)


def test_models_take_dtype_and_run_bias_free_and_bf16():
    """``dtype`` on the GAN's and the CNN's initialisers: the leaves'
    shapes (in the reference's layout) and dtypes are the reference's,
    BatchNorm's statistics stay float32; a bfloat16 discriminator runs
    a float32 batch as the reference does (weights cast to the input's
    dtype)."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for jinit, tinit in ((jgan.init_generator, tgan.init_generator),
                         (jgan.init_discriminator, tgan.init_discriminator)):
        want = jax.eval_shape(lambda k: jinit(k, jnp.bfloat16), key)
        got = tinit(gen, "cpu", dtype=torch.bfloat16)
        assert [_port_shapes_dtypes(layer) for layer in got] == [
            _shapes_dtypes(layer) for layer in want]
    cnn_j = jax.eval_shape(lambda k: jcls.init_cnn(k, dtype=jnp.bfloat16),
                           key)
    cnn_t = tcls.init_cnn(gen, device="cpu", dtype=torch.bfloat16)
    assert sorted(cnn_t) == sorted(cnn_j)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(cnn_t))
    logits = tcls.cnn_apply(cnn_t, torch.zeros(2, 28, 28, 1))
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())

    # one float32 draw, rounded to bfloat16 on both sides
    rng = np.random.default_rng(0)
    d_np = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key in
                         ("scale", "var") else rng.normal(
                             0, 0.05, a.shape)).astype(np.float32),
        jax.eval_shape(lambda k: jgan.init_discriminator(k), key))
    d_j = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if path[-1].key in
                                    ("mean", "var") else jnp.bfloat16), d_np)
    d_t = [state_from_numpy({"x": jax.tree_util.tree_map(
        lambda a: a[None], layer)}, "cpu")["x"] for layer in d_np]
    d_t = [{k: {kk: (vv if kk in ("mean", "var") else
                     vv.to(torch.bfloat16)) for kk, vv in v.items()}
            for k, v in layer.items()} for layer in d_t]
    img = rng.normal(size=(3, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 3).astype(np.int32)
    want, _ = jgan.discriminator_forward(d_j, jnp.asarray(img),
                                         jnp.asarray(y), train=False)
    got, _ = tgan.discriminator_forward(d_t, torch.from_numpy(img)[None],
                                        torch.from_numpy(y)[None],
                                        train=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_bridge_carries_bias_free_leaves_both_ways():
    gen = torch.Generator().manual_seed(0)
    tree = {"conv": tnn.conv2d_init(2, 3, 5, 4, gen, "cpu", use_bias=False),
            "convt": tnn.convT2d_init(2, 3, 5, 4, gen, "cpu",
                                      use_bias=False),
            "fc": tnn.dense_init(2, 6, 5, gen, "cpu", use_bias=False)}
    back = state_from_numpy(state_to_numpy(tree), "cpu")
    assert [p for p, _ in tree_items(back)] == [p for p, _ in
                                               tree_items(tree)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(tree)))
    assert state_to_numpy(tree)["conv"]["w"].shape == (2, 4, 4, 3, 5)


def test_fedavg_uniform_legacy_matches_fused_and_reference():
    dj, cj = _population(jlat)
    dt, ct = _population(tlat)
    gj, gt = jspl.group_by_profile(dj, cj), tspl.group_by_profile(dt, ct)
    params = {}
    for net in ("G", "D"):
        client, _ = random_split_state(gj, net, seed=3)
        for g in gj:
            params.setdefault(g.name, {})[net] = client[g.name]
    sizes = np.array([5, 7, 3, 9, 4, 6], np.float64)
    want = jfed.fedavg_uniform(gj, jax.tree_util.tree_map(jnp.asarray,
                                                          params), sizes)
    out = {}
    for fused in (True, False):
        for use_kernel in (True, False):
            out[fused, use_kernel] = tfed.fedavg_uniform(
                gt, state_from_numpy(params, "cpu"), sizes,
                use_kernel=use_kernel, fused=fused)
    ref = list(tree_items(out[True, False]))
    scale = max(float(x.abs().max()) for _, x in ref)
    for got in out.values():
        for (p, a), (q, b) in zip(tree_items(got), ref):
            assert p == q
            assert float((a - b).abs().max()) <= 1e-5 * scale, p
    got = state_to_numpy(out[False, True])
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        sub = got
        for p in path:
            sub = sub[p.key]
        np.testing.assert_allclose(sub, np.asarray(leaf), rtol=1e-5,
                                   atol=1e-6)


def test_cut_ranges_and_stack_params_match_reference():
    for pair, n in (((1, 4), 5), ((2, 3), 5), ((0, 5), 5), ((3, 3), 5)):
        assert tspl.head_layers(pair) == jspl.head_layers(pair)
        assert tspl.server_layers(pair) == jspl.server_layers(pair)
        assert tspl.tail_layers(pair, n) == jspl.tail_layers(pair, n)
        assert tspl.client_owned_layers(pair, n) == \
            jspl.client_owned_layers(pair, n)
    gen = torch.Generator().manual_seed(0)
    for l, (jdef, tdef) in enumerate(zip(jgan.DISC_LAYER_DEFS,
                                         tgan.DISC_LAYER_DEFS)):
        want = jax.eval_shape(lambda k, jdef=jdef: jspl.stack_params(
            jdef[0], k, 3), jax.random.PRNGKey(l))

        def one(g, device, dtype, tdef=tdef):
            return {k: {kk: vv[0] for kk, vv in v.items()}
                    for k, v in tdef.init(1, g, device, dtype).items()}
        got = tspl.stack_params(one, 3, gen, "cpu")
        assert _shapes_dtypes(want) == _shapes_dtypes(
            state_to_numpy(got))
    # the copies are independent draws
    w = got["fc"]["w"]
    assert not torch.equal(w[0], w[1])


def test_baselines_common_merge_bn_matches_reference():
    rng = np.random.default_rng(0)
    upd = {"0": {"bn": {k: rng.normal(size=3).astype(np.float32)
                        for k in ("scale", "bias", "mean", "var")},
                 "fc": {"w": rng.normal(size=(2, 3)).astype(np.float32)}}}
    bn = {"0": {"bn": {"mean": np.ones(3, np.float32),
                       "var": np.full(3, 2.0, np.float32)}}}
    want = jcommon.merge_bn(upd, bn)
    got = tcommon.merge_bn(state_from_numpy(upd, "cpu"),
                           state_from_numpy(bn, "cpu"))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        sub = got
        for p in path:
            sub = sub[p.key]
        np.testing.assert_array_equal(sub.numpy(), np.asarray(leaf))
