"""The port's LM launchers, LM checkpoints and split transformer against
the JAX package.

  * ``launch.train`` (``train_lm``) and ``launch.serve`` at ``--smoke
    --device cpu`` from the reference launcher's own initial weights
    (``init_lm(PRNGKey(seed))``, through ``bridge.lm_from_numpy``): the
    same printed losses (printed to 4 decimals; the parameters after a
    few Adam steps agree to ~2 lr per step, which moves the loss by far
    less than 1e-3) and the same greedy continuation.
  * A bf16 LM checkpoint written by either package loads in the other
    bit for bit, and ``train_lm --ckpt`` writes one the reference reads.
  * ``core.split_transformer`` on the setup of
    ``tests/test_split_transformer.py`` (granite-3-2b's smoke config at 6
    layers, two weak and two strong clients): the forward's logits
    (1e-4 of the largest), one ``make_split_train_step`` (the loss to
    1e-5, parameters within 2 lr) and ``federate_split_lm`` (1e-6 of
    each leaf's largest value: the same float32 weighted sums).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core import split_transformer as jsplit  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (lm_from_numpy, lm_to_numpy,  # noqa: E402
                                split_transformer_from_numpy)
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core import split_transformer as tsplit  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

LOSS_TOL = 1e-3


def _ref_init(arch, seed=0, **replace):
    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    p = jax.jit(JT.init_lm, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    return jax.tree_util.tree_map(np.asarray, p)


def _printed(out: str, pattern: str):
    return [float(x) for x in re.findall(pattern, out)]


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-tiny"])
def test_train_lm_matches_reference_launcher(arch, capsys):
    """Both launchers on the same argv; whisper cuts its text to
    ``max_target_len`` and draws its frames from ``default_rng(i)``."""
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "24"]
    jtrain.main(argv)
    want = _printed(capsys.readouterr().out, r"loss=([-\d.]+)")
    _, _, state, losses = ttrain.main(
        argv + ["--device", "cpu"],
        params=lm_from_numpy(_ref_init(arch), "cpu"))
    got = _printed(capsys.readouterr().out, r"loss=([-\d.]+)")
    assert len(want) == len(got) == 3 and state.step == 3
    np.testing.assert_allclose(got, want, atol=LOSS_TOL)
    np.testing.assert_allclose([float(x) for x in losses], want,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "llava-next-34b"])
def test_serve_matches_reference_launcher(arch, capsys):
    """Both launchers on the same argv (llava's patch embeddings from the
    prompt's generator); greedy decoding."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
            "40", "--gen", "8"]
    jserve.main(argv)
    want = re.findall(r"continuation \(seq 0\): (\[.*\])",
                      capsys.readouterr().out)
    res = tserve.main(argv + ["--device", "cpu"],
                      params=lm_from_numpy(_ref_init(arch), "cpu"))
    got = re.findall(r"continuation \(seq 0\): (\[.*\])",
                     capsys.readouterr().out)
    assert got == want and len(want) == 1
    assert res["tokens"].shape == (2, 8)
    assert res["tokens"][0].tolist() == eval(want[0])


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_bf16_checkpoint_crosses_packages(tmp_path):
    """A bf16 LM tree written by the reference loads onto the port's
    template bit for bit, and the port's file loads in the reference."""
    ref = _ref_init("granite-moe-1b-a400m", seed=1, param_dtype="bfloat16")
    assert ref["embed"]["table"].dtype.name == "bfloat16"
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save_checkpoint(jpath, ref, step=7)
    cfg = dataclasses.replace(
        tconfigs.get_smoke_config("granite-moe-1b-a400m"),
        param_dtype="bfloat16")
    template = TT.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    loaded, step = tckpt.load_checkpoint(jpath, template)
    assert step == 7
    got = lm_to_numpy(loaded)
    n = 0
    for path, want in tree_items(ref):
        g = got
        for k in path:
            g = g[k]
        assert _same_bits(g, want), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref))
    assert loaded["embed"]["table"].dtype == torch.bfloat16
    assert loaded["blocks"]["p0_attn"]["moe"]["router"].dtype == torch.float32
    tckpt.save_checkpoint(tpath, lm_from_numpy(ref, "cpu"), step=9)
    back, step = jckpt.load_checkpoint(tpath, ref)
    assert step == 9
    for (_, a), (_, b) in zip(tree_items(jax.tree_util.tree_map(
            np.asarray, back)), tree_items(ref)):
        assert _same_bits(a, b)


def test_train_lm_checkpoint_loads_in_reference(tmp_path, capsys):
    path = str(tmp_path / "lm.ckpt")
    _, params, _, _ = ttrain.main(
        ["--arch", "qwen1.5-4b", "--smoke", "--steps", "1", "--batch", "2",
         "--seq", "16", "--device", "cpu", "--ckpt", path])
    assert f"checkpoint -> {path}" in capsys.readouterr().out
    template = jax.eval_shape(
        lambda k: JT.init_lm(k, get_smoke_config("qwen1.5-4b")),
        jax.random.PRNGKey(0))
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), template)
    loaded, step = jckpt.load_checkpoint(path, template)
    assert step == 1
    want = lm_to_numpy(params)
    for (pa, a), (pb, b) in zip(tree_items(jax.tree_util.tree_map(
            np.asarray, loaded)), tree_items(want)):
        assert pa == pb and _same_bits(a, b)


# ---------------------------------------------------------------------------
# split transformer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split_setup():
    cfg = dataclasses.replace(get_smoke_config("granite-3-2b"), n_layers=6)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("granite-3-2b"),
                               n_layers=6)
    groups = jsplit.default_groups(cfg, n_weak=2, n_strong=2)
    tgroups = tsplit.default_groups(tcfg, n_weak=2, n_strong=2)
    params = jax.tree_util.tree_map(
        np.asarray, jsplit.init_split_lm(jax.random.PRNGKey(0), cfg, groups))
    rng = np.random.default_rng(0)
    batch = {kind: {g.name: rng.integers(0, cfg.vocab, (g.n_clients, 2, 16)
                                         ).astype(np.int32) for g in groups}
             for kind in ("tokens", "labels")}
    return cfg, tcfg, groups, tgroups, params, batch


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _tbatch(batch):
    return {k: {g: torch.tensor(v) for g, v in d.items()}
            for k, d in batch.items()}


def test_split_groups_and_init_match_reference(split_setup):
    cfg, tcfg, groups, tgroups, params, _ = split_setup
    assert [dataclasses.astuple(g) for g in groups] == \
        [dataclasses.astuple(g) for g in tgroups]
    mine = tsplit.init_split_lm(tcfg, tgroups,
                                torch.Generator().manual_seed(0), "cpu")
    want = {p: x.shape for p, x in tree_items(params)}
    assert {p: tuple(x.shape) for p, x in tree_items(mine)} == want


def test_split_forward_and_train_step(split_setup):
    cfg, tcfg, groups, tgroups, params, batch = split_setup
    lr = 3e-4
    jstep, jinit = jsplit.make_split_train_step(cfg, groups, lr=lr)

    def ref(p, b):
        return (jsplit.split_lm_forward(cfg, p, groups, b["tokens"]),
                jstep(p, jinit(p), b))
    want, (jp1, _, jm) = jax.jit(ref)(params, batch)
    tp = split_transformer_from_numpy(params, "cpu")
    got = tsplit.split_lm_forward(tcfg, tp, tgroups,
                                  _tbatch(batch)["tokens"])
    for g in groups:
        _close(got[g.name].detach().numpy(), want[g.name], 1e-4, g.name)
    tstep, tinit = tsplit.make_split_train_step(tcfg, tgroups, lr=lr)
    tp1, ts, tm = tstep(tp, tinit(tp), _tbatch(batch))
    assert ts.step == 1
    _close(tm["loss"].numpy(), jm["loss"], 1e-5, "loss")
    got = dict(tree_items(tp1))
    for path, want_leaf in tree_items(jax.tree_util.tree_map(np.asarray,
                                                             jp1)):
        err = np.abs(got[path].numpy().astype(np.float64) - want_leaf).max()
        assert err <= 2 * lr, (path, err)


def test_federate_split_lm_matches_reference(split_setup):
    """Clusters that cross the profile groups, uneven weights: every
    client leaf equals the reference's, and the server is untouched."""
    cfg, tcfg, groups, tgroups, params, _ = split_setup
    labels = np.array([0, 1, 1, 0])
    weights = np.array([0.2, 0.5, 0.3, 0.9])
    want = jsplit.federate_split_lm(
        jax.tree_util.tree_map(jnp.asarray, params), groups, weights, labels)
    tp = split_transformer_from_numpy(params, "cpu")
    got = tsplit.federate_split_lm(tp, tgroups, weights, labels)
    g = dict(tree_items(got))
    for path, w in tree_items(jax.tree_util.tree_map(np.asarray, want)):
        _close(g[path].numpy(), w, 1e-6, path)
    assert got["server"] is tp["server"]
    # inputs untouched
    for path, x in tree_items(tp):
        assert _same_bits(x.numpy(), dict(tree_items(params))[path]), path
