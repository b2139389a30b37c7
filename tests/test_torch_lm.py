"""The port's LM family against the JAX package, model by model: for
every architecture's smoke config (float32) the forward logits and the
loss, the prefill logits and cache, three decode steps (with a ring
wrap of the windowed caches), and one Adam step of ``make_train_step``;
then the MoE router's ties, the LM layers of ``models.nn``, ``adam``'s
clipping, weight decay and schedules, and ``lm_batches``.

Parameters take the tree, shapes and dtypes of the reference's
``init_lm`` (traced with ``jax.eval_shape``), their values come from a
numpy seed (running ``init_lm`` would cost seconds per architecture),
and they cross with ``bridge.lm_from_numpy``; so do the inputs.
``test_init_lm_tree_matches_reference`` holds the port's own
``init_lm`` to the same tree. Tolerances:
  * logits and caches: 1e-4 of the largest magnitude. The two packages
    sum float32 products in different orders (and the port takes one
    softmax per query chunk where the reference runs an online softmax
    over key chunks), which leaves ~1e-6; 1e-4 keeps two orders of
    magnitude above it.
  * RG-LRU configs (recurrentgemma): 2e-4. Its recurrence runs as a
    log-depth scan in the port and as ``lax.associative_scan`` in the
    reference; both multiply the same decays in another association,
    one more rounding per level of the scan (~log2 S).
  * after one Adam step: 2 lr of the step. Adam's step is at most ~lr
    per element; a gradient that is zero up to rounding can take either
    sign in either package (the ROADMAP's Queue 3 bound).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.data import tokens as jtok  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import lm_from_numpy, lm_to_numpy  # noqa: E402
from repro_torch.data import tokens as ttok  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ARCHS = list_archs()
TOL = 1e-4
RGLRU_TOL = 2e-4
B, S, S_DEC, MARGIN, N_DECODE = 2, 40, 12, 4, 3
WINDOW = 16          # replaces a sliding window, so prompt + decode wraps
LR = 1e-3


def _cfgs(arch):
    j, t = jget_smoke(arch), tconfigs.get_smoke_config(arch)
    if j.sliding_window is not None:
        j = dataclasses.replace(j, sliding_window=WINDOW)
        t = dataclasses.replace(t, sliding_window=WINDOW)
    return j, t


def ref_params(cfg, seed=0):
    """Parameters in the tree, shapes and dtypes of the reference's
    ``init_lm`` (traced, not run), drawn with numpy: weights N(0, 1/fan
    in), norm scales U(0.5, 1.5), biases N(0, 0.1), RG-LRU's ``lambda``
    as the reference draws it (a decay a^(1/8) in [0.9, 0.999)), so that
    every path carries a nonzero value."""
    shapes = jax.eval_shape(lambda k: JT.init_lm(k, cfg),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [k.key for k in path]
        name = names[-1]
        # the weight's own axes: past the stacking axis and an expert axis
        core = leaf.shape[(names[0] in ("blocks", "enc_blocks"))
                          + ("moe" in names and name != "router"):]
        if name == "scale":
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("bias", "bq", "bk", "bv"):
            a = rng.normal(0, 0.1, leaf.shape)
        elif name == "lambda":
            u = rng.uniform(0.9 ** 2, 0.999 ** 2, leaf.shape)
            a = np.log(np.expm1(-np.log(u) / 8.0))
        else:
            fan_in = (core[-1] if name == "table" else
                      int(np.prod(core[:-1])) if name == "wo" else core[0])
            a = rng.normal(0, 1 / np.sqrt(fan_in), leaf.shape)
        return a.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def ref_inputs(cfg, seed=0):
    """A batch of the smoke shapes: tokens and next-token labels, plus a
    VLM's patch embeddings or an encoder's frames."""
    rng = np.random.default_rng(seed)
    n = S_DEC if cfg.is_encoder_decoder else S - (
        cfg.num_prefix_embeds if cfg.frontend == "vision" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.normal(
            0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["enc_frames"] = rng.normal(
            0, 1, (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _extra(batch):
    return {k: batch[k] for k in ("prefix_embeds", "enc_frames")
            if k in batch}


def _ref_run(cfg, params, batch):
    """Forward, prefill, N_DECODE greedy decode steps (one scan), and one
    train step with the launcher's optimiser."""
    logits, aux = JT.forward_train(cfg, params, batch["tokens"],
                                   **_extra(batch))
    pl, cache = JT.prefill(cfg, params, batch["tokens"], margin=MARGIN,
                           **_extra(batch))

    def dec(carry, _):
        cur, cache = carry
        lg, cache = JT.decode_step(cfg, params, cur, cache)
        return (jnp.argmax(lg, -1).astype(jnp.int32), cache), (cur, lg, cache)

    cur0 = jnp.argmax(pl, -1).astype(jnp.int32)
    _, (toks, dec_logits, caches) = jax.lax.scan(dec, (cur0, cache), None,
                                                 length=N_DECODE)
    step, opt_init = JT.make_train_step(cfg, _train_opt(jadam, jsched))
    p1, _, m = step(params, opt_init(params), batch)
    return {"logits": logits, "aux": aux, "prefill": pl, "cache0": cache,
            "toks": toks, "dec": dec_logits, "caches": caches,
            "train_loss": m["loss"], "train_params": p1}


def _train_opt(lib_adam, sched):
    return lib_adam(sched.warmup_cosine(LR, 10, 20), grad_clip=1.0)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """One architecture: the reference's outputs (one jit) and the
    port's inputs."""
    jcfg, tcfg = _cfgs(request.param)
    pn = ref_params(jcfg)
    batch = ref_inputs(jcfg)
    ref = jax.device_get(jax.jit(functools.partial(_ref_run, jcfg))(
        pn, {k: jnp.asarray(v) for k, v in batch.items()}))
    return {"arch": request.param, "cfg": tcfg, "params": pn,
            "batch": batch, "ref": ref}


def _tol(cfg):
    return RGLRU_TOL if "rglru" in cfg.block_pattern else TOL


def assert_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, \
        f"{what}: max |d| {err:.3e} > {tol} x {scale:.3e}"


def assert_cache(got, want, tol, what):
    """Every leaf of a port cache against the reference's, the length
    exactly."""
    assert got["length"] == int(want["length"]), what
    n = 0
    for path, leaf in tree_items({k: v for k, v in got.items()
                                  if k != "length"}):
        ref = want
        for k in path:
            ref = ref[k]
        assert_close(leaf.numpy(), ref, tol, f"{what} {'/'.join(path)}")
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want)) - 1, what


def _port_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_forward_and_loss(case):
    cfg, ref = case["cfg"], case["ref"]
    params = lm_from_numpy(case["params"], "cpu")
    batch = _port_batch(case["batch"])
    logits, aux = TT.forward_train(cfg, params, batch["tokens"],
                                   **_extra(batch))
    assert_close(logits.numpy(), ref["logits"], _tol(cfg), "logits")
    assert_close(aux.numpy(), ref["aux"], TOL, "moe aux")
    loss, metrics = TT.lm_loss(cfg, params, batch)
    assert_close(loss.numpy(), ref["train_loss"], 1e-5, "loss")
    assert set(metrics) == {"nll", "moe_aux"}


def test_prefill_and_decode(case):
    """Prefill logits and cache, then N_DECODE decode steps on the
    reference's tokens: each step's logits and the whole cache. With a
    prompt of 40 and windows of 16 (mixtral) and 32 (recurrentgemma's
    local attention) the kept window is rolled into the ring and the
    decode slots wrap."""
    cfg, ref = case["cfg"], case["ref"]
    tol = _tol(cfg)
    params = lm_from_numpy(case["params"], "cpu")
    batch = _port_batch(case["batch"])
    logits, cache = TT.prefill(cfg, params, batch["tokens"], margin=MARGIN,
                               **_extra(batch))
    assert_close(logits.numpy(), ref["prefill"], tol, "prefill logits")
    assert_cache(cache, ref["cache0"], tol, "prefill cache")
    for i in range(N_DECODE):
        tok = torch.tensor(np.asarray(ref["toks"][i]))
        logits, cache = TT.decode_step(cfg, params, tok, cache)
        assert_close(logits.numpy(), ref["dec"][i], tol, f"decode {i}")
        assert_cache(cache, jax.tree_util.tree_map(lambda x: x[i],
                                                   ref["caches"]),
                     tol, f"cache {i + 1}")


def test_train_step(case):
    """One ``make_train_step`` update with the launcher's optimiser
    (warm-up cosine lr, clipping at 1.0): the loss, and every parameter
    within 2 lr of the step."""
    cfg, ref = case["cfg"], case["ref"]
    params = lm_from_numpy(case["params"], "cpu")
    step, opt_init = TT.make_train_step(cfg, _train_opt(topt.adam, tsched))
    new, state, m = step(params, opt_init(params), _port_batch(case["batch"]))
    assert state.step == 1
    assert_close(m["loss"].numpy(), ref["train_loss"], 1e-5, "train loss")
    bound = 2 * tsched.warmup_cosine(LR, 10, 20)(1)
    got = lm_to_numpy(new)
    moved = 0
    for path, want in tree_items(ref["train_params"]):
        g = got
        for k in path:
            g = g[k]
        err = float(np.abs(np.asarray(g, np.float64) - want).max())
        assert err <= bound, f"{'/'.join(path)}: {err:.3e} > {bound:.3e}"
        moved += not np.array_equal(g, _at(case["params"], path))
    assert moved > 0


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    """The port's configs are the reference's, field by field (dtype as
    its torch counterpart), with the same parameter counts."""
    from repro.configs import get_config as jget
    for jc, tc in ((jget(arch), tconfigs.get_config(arch)),
                   (jget_smoke(arch), tconfigs.get_smoke_config(arch))):
        for f in dataclasses.fields(jc):
            assert getattr(jc, f.name) == getattr(tc, f.name), f.name
        assert tc.dtype == (torch.bfloat16 if jc.param_dtype == "bfloat16"
                            else torch.float32)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
    assert tconfigs.list_archs() == list_archs()


def test_init_lm_tree_matches_reference():
    """``init_lm`` builds the reference's tree, shapes and dtypes (bf16
    at the full configs' dtype), drawing on the generator's device."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        want = jax.eval_shape(lambda k: JT.init_lm(k, jcfg),
                              jax.random.PRNGKey(0))
        got = TT.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
        w = dict(tree_items(jax.tree_util.tree_map(lambda x: x, want)))
        g = dict(tree_items(got))
        assert sorted(g) == sorted(w), arch
        for path, x in g.items():
            assert tuple(x.shape) == tuple(w[path].shape), (arch, path)
        jb = dataclasses.replace(jcfg, param_dtype="bfloat16")
        tb = dataclasses.replace(tcfg, param_dtype="bfloat16")
        assert TT.init_lm(tb, torch.Generator().manual_seed(0), "cpu")[
            "embed"]["table"].dtype == torch.bfloat16
        assert jb.dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# MoE ties
# ---------------------------------------------------------------------------

def test_moe_router_ties():
    """A router whose probabilities tie (zero weights: every expert
    1/E; and repeated columns) picks the lowest expert indices, as
    ``lax.top_k`` does, so capacity overflow drops the same tokens: the
    same output, expert counts and aux losses as the reference."""
    rng = np.random.default_rng(3)
    Bm, Sm, D, F, E, k = 2, 16, 8, 12, 4, 2
    x = rng.normal(0, 1, (Bm, Sm, D)).astype(np.float32)
    base = {"wi": rng.normal(0, 0.3, (E, D, F)),
            "wg": rng.normal(0, 0.3, (E, D, F)),
            "wo": rng.normal(0, 0.3, (E, F, D))}
    col = rng.normal(0, 1, (D, 1))
    routers = {"all_equal": np.zeros((D, E)),
               "pairs": np.concatenate([col, col, -col, -col], 1)}
    for name, router in routers.items():
        p = {k_: v.astype(np.float32) for k_, v in base.items()}
        p["router"] = router.astype(np.float32)
        jo, ja = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(x), top_k=k, capacity_factor=1.0)
        to, ta = tmoe.moe_apply({k_: torch.tensor(v) for k_, v in p.items()},
                                torch.tensor(x), top_k=k, capacity_factor=1.0)
        np.testing.assert_array_equal(ta["expert_counts"].numpy(),
                                       np.asarray(ja["expert_counts"]))
        assert_close(to.numpy(), jo, TOL, f"{name} out")
        for key in ("load_balance", "router_z"):
            assert_close(ta[key].numpy(), ja[key], 1e-6, f"{name} {key}")
        _, idx = tmoe.top_k_stable(torch.tensor(np.asarray(
            jax.nn.softmax(jnp.asarray(x) @ p["router"]))), k)
        _, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ p["router"]),
                               k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# nn layers, optimiser, schedules, token streams
# ---------------------------------------------------------------------------

def test_lm_layers_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, (2, 9, 16)).astype(np.float32)
    ln = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
          "bias": rng.normal(0, 0.1, 16).astype(np.float32)}
    t = {k: torch.tensor(v) for k, v in ln.items()}
    assert_close(tnn.layernorm_apply(t, torch.tensor(x)).numpy(),
                 jnn.layernorm_apply(ln, jnp.asarray(x)), 1e-6, "layernorm")
    assert_close(tnn.rmsnorm_apply(t, torch.tensor(x)).numpy(),
                 jnn.rmsnorm_apply(ln, jnp.asarray(x)), 1e-6, "rmsnorm")
    table = rng.normal(0, 1, (11, 16)).astype(np.float32)
    assert_close(tnn.embedding_attend({"table": torch.tensor(table)},
                                      torch.tensor(x)).numpy(),
                 jnn.embedding_attend({"table": table}, jnp.asarray(x)),
                 1e-6, "embedding_attend")
    g = rng.normal(0, 2, x.shape).astype(np.float32)
    assert_close(tnn.geglu(torch.tensor(x), torch.tensor(g)).numpy(),
                 jnn.geglu(jnp.asarray(x), jnp.asarray(g)), 1e-6, "geglu")
    assert_close(tnn.swiglu(torch.tensor(x), torch.tensor(g)).numpy(),
                 jnn.swiglu(jnp.asarray(x), jnp.asarray(g)), 1e-6, "swiglu")
    for kernel, stride, pad in ((3, 1, "SAME"), (4, 2, "SAME"),
                                (3, 2, "VALID")):
        conv = {"w": rng.normal(0, 0.3, (kernel, 16, 5)).astype(np.float32),
                "b": rng.normal(0, 0.1, 5).astype(np.float32)}
        want = jnn.conv1d_apply(conv, jnp.asarray(x), stride=stride,
                                padding=pad)
        got = tnn.conv1d_apply({k: torch.tensor(v) for k, v in conv.items()},
                               torch.tensor(x), stride=stride, padding=pad)
        assert_close(got.numpy(), want, 1e-5, f"conv1d {kernel}/{stride}")
    c = tnn.conv1d_init(16, 5, 3, torch.Generator().manual_seed(0), "cpu")
    assert c["w"].shape == (3, 16, 5) and c["b"].shape == (5,)
    tree = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.bfloat16)}}
    jtree = {"a": jnp.zeros((3, 4)), "b": {"c": jnp.zeros(5, jnp.bfloat16)}}
    assert tnn.tree_size(tree) == jnn.tree_size(jtree) == 17
    assert tnn.tree_bytes(tree) == jnn.tree_bytes(jtree) == 58


def test_adam_clip_decay_schedule_match_reference():
    """``adam`` with a warm-up cosine lr, global-norm clipping (the clip
    active) and weight decay: three steps give the reference's
    parameters and moments within float32 rounding; the schedules give
    the reference's lr at every step (within float32 rounding of its
    cosine, 1e-6 relative)."""
    for sched in (lambda m: m.warmup_cosine(0.1, 3, 8),
                  lambda m: m.linear_decay(0.1, 6), lambda m: m.constant(0.1)):
        for step in range(0, 12):
            want = float(sched(jsched)(jnp.asarray(step)))
            assert abs(sched(tsched)(step) - want) <= 1e-6 * abs(want)
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
              "b": {"c": rng.normal(0, 1, 5).astype(np.float32)}}
    j_init, j_upd = jadam(jsched.warmup_cosine(0.1, 3, 8), grad_clip=0.5,
                          weight_decay=0.01)
    t_init, t_upd = topt.adam(tsched.warmup_cosine(0.1, 3, 8), grad_clip=0.5,
                              weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {"w": torch.tensor(params["w"]),
          "b": {"c": torch.tensor(params["b"]["c"])}}
    js, ts = j_init(jp), t_init(tp)
    for i in range(3):
        g = {"w": rng.normal(0, 3, (4, 3)).astype(np.float32),
             "b": {"c": rng.normal(0, 3, 5).astype(np.float32)}}
        js, jp = j_upd(js, jax.tree_util.tree_map(jnp.asarray, g), jp)
        ts, tp = t_upd(ts, {"w": torch.tensor(g["w"]),
                            "b": {"c": torch.tensor(g["b"]["c"])}}, tp)
    assert ts.step == int(js.step) == 3
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        assert_close(got["w"].numpy(), want["w"], 1e-6, "w")
        assert_close(got["b"]["c"].numpy(), want["b"]["c"], 1e-6, "c")


def test_adam_bf16_params_update_in_float32():
    """A bf16 parameter is updated in float32 and cast back, as in the
    reference."""
    p = np.linspace(-1, 1, 7).astype(np.float32)
    g = np.linspace(0.3, -0.2, 7).astype(np.float32)
    j_init, j_upd = jadam(0.05, grad_clip=1.0)
    t_init, t_upd = topt.adam(0.05, grad_clip=1.0)
    jp = {"p": jnp.asarray(p, jnp.bfloat16)}
    tp = {"p": torch.tensor(p).to(torch.bfloat16)}
    _, jp = j_upd(j_init(jp), {"p": jnp.asarray(g, jnp.bfloat16)}, jp)
    _, tp = t_upd(t_init(tp), {"p": torch.tensor(g).to(torch.bfloat16)}, tp)
    assert tp["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(lm_to_numpy(tp)["p"].astype(np.float32),
                                  np.asarray(jp["p"], np.float32))


def test_lm_batches_byte_identical():
    for vocab, batch, seq, seed in ((256, 2, 40, 0), (49155, 3, 128, 7)):
        jg = jtok.lm_batches(vocab, batch, seq, seed=seed)
        tg = ttok.lm_batches(vocab, batch, seq, seed=seed)
        for _ in range(3):
            (jt, jl), (tt, tl) = next(jg), next(tg)
            assert jt.dtype == tt.dtype and jt.tobytes() == tt.tobytes()
            assert jl.tobytes() == tl.tobytes()
    rng_j, rng_t = np.random.default_rng(1), np.random.default_rng(1)
    assert (jtok.zipf_tokens(rng_j, 100, 50).tobytes()
            == ttok.zipf_tokens(rng_t, 100, 50).tobytes())


def test_entry_points_default_to_cuda():
    """Without ``device="cpu"`` the LM entry points go to the card, or
    raise where there is none: they never run on the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    from repro_torch.core import split_transformer as tsplit
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    cfg = tconfigs.get_smoke_config("granite-3-2b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.init_lm(cfg, gen)
    split_cfg = dataclasses.replace(cfg, n_layers=6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsplit.init_split_lm(split_cfg, tsplit.default_groups(split_cfg), gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "granite-3-2b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_from_numpy({"embed": np.zeros((4, 2), np.float32)})
