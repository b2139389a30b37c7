"""The port's layers and optimizer against the JAX package's, forward and
gradients, one test per hazard of the translation:

  (a) ``convT2d_apply``: ``lax.conv_transpose`` without
      ``transpose_kernel`` on an HWIO kernel with "SAME" padding;
  (b) "SAME" stride-2 conv from 7 to 4 pads (1, 2), asymmetrically;
  (c) BatchNorm keeps 0.9 of the old statistic, takes the biased
      variance and reduces over every axis but the last, per client;
  and Adam (eps outside sqrt(vhat), float32 step in the corrections).

JAX runs each layer under ``vmap`` over K stacked clients; the port
runs them as one grouped call. Parameters are drawn by the reference's
initializers and carried over with ``repro_torch.bridge``. Tolerance:
float32 convolutions sum in different orders in XLA and PyTorch, so
outputs and gradients of order 1 agree to ~1e-6; 1e-4 leaves margin.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import gan as jgan  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.models import gan as tgan  # noqa: E402
from repro_torch.models import nn as tnn  # noqa: E402
from repro_torch.optim.optimizers import adam as tadam  # noqa: E402

TOL = 1e-4
K, B = 2, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("s", [1, 2])
def test_convT2d_matches_lax_conv_transpose(k, s):
    """Hazard (a): the port flips the kernel, swaps I/O and matches
    JAX's "SAME" transpose padding (asymmetric for k=3, s=2 and k=4,
    s=1)."""
    rng = np.random.default_rng(10 * k + s)
    w = rng.normal(size=(K, k, k, 4, 3)).astype(np.float32)
    b = rng.normal(size=(K, 3)).astype(np.float32)
    x = rng.normal(size=(K, B, 5, 6, 4)).astype(np.float32)
    params = {"w": w, "b": b}
    jax_fn = lambda p, xx: jnn.convT2d_apply(p, xx, stride=s)  # noqa: E731

    rng2 = np.random.default_rng(0)
    jx = jnp.asarray(x)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y_j = jax.jit(jax.vmap(jax_fn))(jp, jx)
    assert y_j.shape == (K, B, 5 * s, 6 * s, 3)
    r = rng2.normal(size=y_j.shape).astype(np.float32)
    gp_j, gx_j = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jax.vmap(jax_fn)(p, xx) * r),
        argnums=(0, 1)))(jp, jx)

    tp = state_from_numpy({"convt": params}, "cpu")["convt"]
    tp = {n: v.requires_grad_(True) for n, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y_t = tnn.convT2d_apply(tp, tx, stride=s)
    _close(y_t.detach().numpy(), y_j)
    (y_t * torch.from_numpy(r)).sum().backward()
    _close(tx.grad.numpy(), gx_j)
    g = state_to_numpy({"convt": {n: v.grad for n, v in tp.items()}})["convt"]
    _close(g["w"], gp_j["w"])
    _close(g["b"], gp_j["b"])


@pytest.mark.parametrize("size,k,s", [(7, 4, 2), (7, 3, 1), (28, 4, 2),
                                      (14, 4, 2)])
def test_conv2d_same_padding_matches_xla(size, k, s):
    """Hazard (b): "SAME" with stride 2 from 7 to 4 pads (1, 2); the
    port pads explicitly with F.pad."""
    if (size, k, s) == (7, 4, 2):
        assert tnn.same_pads(7, 4, 2) == (1, 2)
    rng = np.random.default_rng(size + k + s)
    params = {"w": rng.normal(size=(K, k, k, 4, 5)).astype(np.float32),
              "b": rng.normal(size=(K, 5)).astype(np.float32)}
    x = rng.normal(size=(K, B, size, size, 4)).astype(np.float32)
    jax_fn = lambda p, xx: jnn.conv2d_apply(p, xx, stride=s)  # noqa: E731
    jx, jp = jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, params)
    y_j = jax.jit(jax.vmap(jax_fn))(jp, jx)
    assert y_j.shape[2] == -(-size // s)
    r = rng.normal(size=y_j.shape).astype(np.float32)
    gp_j, gx_j = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jax.vmap(jax_fn)(p, xx) * r),
        argnums=(0, 1)))(jp, jx)

    tp = state_from_numpy({"conv": params}, "cpu")["conv"]
    tp = {n: v.requires_grad_(True) for n, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y_t = tnn.conv2d_apply(tp, tx, stride=s)
    _close(y_t.detach().numpy(), y_j)
    (y_t * torch.from_numpy(r)).sum().backward()
    _close(tx.grad.numpy(), gx_j)
    g = state_to_numpy({"conv": {n: v.grad for n, v in tp.items()}})["conv"]
    _close(g["w"], gp_j["w"])
    _close(g["b"], gp_j["b"])


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_reference(train):
    """Hazard (c): per-client statistics over every axis but the last,
    biased variance, momentum 0.9 on the running statistics."""
    rng = np.random.default_rng(int(train))
    C = 6
    params = {"scale": rng.uniform(0.5, 2, (K, C)).astype(np.float32),
              "bias": rng.normal(size=(K, C)).astype(np.float32),
              "mean": rng.normal(size=(K, C)).astype(np.float32),
              "var": rng.uniform(0.5, 2, (K, C)).astype(np.float32)}
    x = (rng.normal(size=(K, B, 4, 5, C)) * 3 + 1).astype(np.float32)

    def jfn(p, xx):
        return jnn.batchnorm_apply(p, xx, train=train)

    jp, jx = jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)
    y_j, new_j = jax.jit(jax.vmap(jfn))(jp, jx)
    r = rng.normal(size=y_j.shape).astype(np.float32)
    gp_j, gx_j = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jax.vmap(jfn)(p, xx)[0] * r),
        argnums=(0, 1)))(jp, jx)

    tp = {n: torch.from_numpy(v).requires_grad_(n in ("scale", "bias"))
          for n, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y_t, new_t = tnn.batchnorm_apply(tp, tx, train=train)
    _close(y_t.detach().numpy(), y_j)
    for n in ("mean", "var"):
        _close(new_t[n].detach().numpy(), new_j[n], tol=1e-5)
    (y_t * torch.from_numpy(r)).sum().backward()
    _close(tx.grad.numpy(), gx_j)
    for n in ("scale", "bias"):
        _close(tp[n].grad.numpy(), gp_j[n])


@pytest.mark.parametrize("net,layer", [(n, l) for n in ("G", "D")
                                       for l in range(5)])
def test_gan_layer_matches_reference(net, layer):
    """Every Table-3 layer (dense, embedding, conv, convT, BN, ReLU,
    LeakyReLU, tanh): outputs and updated BN state from the reference's
    initial weights, in train mode."""
    jdefs = jgan.GEN_LAYER_DEFS if net == "G" else jgan.DISC_LAYER_DEFS
    tdefs = tgan.NET_LAYER_DEFS[net]
    keys = jax.random.split(jax.random.PRNGKey(layer), K)
    jp = jax.jit(jax.vmap(lambda kk: jdefs[layer][0](kk, jnp.float32)))(keys)
    rng = np.random.default_rng(layer)
    in_shapes = {"G": [None, (7, 7, 256), (14, 14, 128), (14, 14, 128),
                       (28, 28, 64)],
                 "D": [None, (14, 14, 64), (7, 7, 128), (7, 7, 128),
                       (4, 4, 256)]}
    if layer == 0:
        first = ((K, B, jgan.Z_DIM) if net == "G" else (K, B, 28, 28, 1))
        xs = (rng.normal(size=first).astype(np.float32),
              rng.integers(0, 10, (K, B)).astype(np.int32))
        y_j, new_j = jax.jit(jax.vmap(
            lambda p, a, b: jdefs[0][1](p, (a, b), True)))(
                jp, *map(jnp.asarray, xs))
        tx = tuple(torch.from_numpy(a) for a in xs)
    else:
        x = rng.normal(size=(K, B) + in_shapes[net][layer]).astype(np.float32)
        y_j, new_j = jax.jit(jax.vmap(
            lambda p, a: jdefs[layer][1](p, a, True)))(jp, jnp.asarray(x))
        tx = torch.from_numpy(x)
    y_t, new_t = tdefs[layer].apply(state_from_numpy(_np(jp), "cpu"), tx, True)
    _close(y_t.numpy(), y_j)
    want = _np(new_j)
    got = state_to_numpy(new_t)
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        sub = got
        for p in path:
            sub = sub[p.key]
        _close(sub, leaf, tol=1e-5)


def test_bce_logits_matches_reference():
    logits = np.random.default_rng(0).normal(size=(40,)).astype(np.float32) * 4
    for t in (0.0, 1.0):
        _close(float(tgan.bce_logits(torch.from_numpy(logits), t)),
               float(jgan.bce_logits(jnp.asarray(logits), t)), tol=1e-6)


def test_adam_matches_reference():
    """Three Adam steps over a tree with a zero-gradient leaf (like the
    BN statistics): eps outside sqrt(vhat), float32 step corrections."""
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": np.zeros(5, np.float32) if i == 1
              else rng.normal(size=(5,)).astype(np.float32) * 1e-3}
             for i in range(3)]
    j_init, j_upd = jadam(2e-4, b1=0.5)
    t_init, t_upd = tadam(2e-4, b1=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = state_from_numpy(params, "cpu")
    js, ts = j_init(jp), t_init(tp)
    for g in grads:
        js, jp = j_upd(js, jax.tree_util.tree_map(jnp.asarray, g), jp)
        ts, tp = t_upd(ts, state_from_numpy(g, "cpu"), tp)
    assert ts.step == int(js.step) == 3
    _close(tp["a"]["w"].numpy(), jp["a"]["w"], tol=1e-7)
    _close(tp["b"].numpy(), jp["b"], tol=1e-7)
    _close(ts.nu["a"]["w"].numpy(), js.nu["a"]["w"], tol=1e-7)
