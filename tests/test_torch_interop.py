"""Checkpoints across the two packages, and the port's launcher and
config surface against the reference's.

A checkpoint file records JAX's treedef string beside the leaves, and
both ``load_checkpoint``s compare it, so the port writes and compares
the same string: a file written by either package loads through the
other's loader, with every leaf equal bit for bit. The trainer states
are the reference's initial state, carried to the port with ``bridge``.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import huscf as jhuscf  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.optim.optimizers import AdamState as JAdam  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.core import huscf as thuscf  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim.optimizers import AdamState as TAdam  # noqa: E402

Pair = collections.namedtuple("Pair", ["a", "b"])


def _trees(adam):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = np.int32(4)
    return {
        "dicts": {"G": {"w": x, "b": y}, "D": {}, "a-b": x, "q'": y},
        "adam": {"opt": adam(y, {"w": x, "b": [x]}, {"w": x, "b": [x]})},
        "lists": [x, [y, x], [], [[x]]],
        "tuples": (x, (y, x), (), ((x,),)),
        "one_tuple": (x,),
        "none": {"a": None, "b": [None, x], "c": (None,)},
        "leaf": x,
        "namedtuple": Pair(x, Pair(None, [y])),
        "mixed": {"G": {"b": [x, x], "w": x},
                  "opt": adam(y, {"x": x}, (x, None))},
    }


@pytest.mark.parametrize("case", sorted(_trees(JAdam)))
def test_treedef_string_equals_jax(case):
    jt, tt = _trees(JAdam)[case], _trees(TAdam)[case]
    leaves, desc = tckpt.tree_flatten(tt)
    want_leaves, want = jax.tree_util.tree_flatten(jt)
    assert desc == str(want)
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(_trees(JAdam)))
def test_small_trees_cross_both_loaders(tmp_path, case):
    """A file written by each package loads through the other's loader
    onto the same structure (lists, tuples and None rebuilt)."""
    jt, tt = _trees(JAdam)[case], _trees(TAdam)[case]
    jckpt.save_checkpoint(str(tmp_path / "j.ckpt"), jt, step=2)
    back, step = tckpt.load_checkpoint(str(tmp_path / "j.ckpt"), tt)
    assert step == 2
    assert tckpt.tree_flatten(back)[1] == tckpt.tree_flatten(tt)[1]
    for a, b in zip(tckpt.tree_flatten(back)[0], tckpt.tree_flatten(tt)[0]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    tckpt.save_checkpoint(str(tmp_path / "t.ckpt"), tt, step=3)
    back, step = jckpt.load_checkpoint(str(tmp_path / "t.ckpt"), jt)
    assert step == 3
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jt))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jt)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.fixture(scope="module")
def trainer_pair():
    """The reference's and the port's trainer on one 4-client population
    (base size 24, fixed cuts), the port holding the reference's state."""
    def setup(lat, part):
        clients = part.build_scenario("2dom_noniid", num_clients=4,
                                      base_size=24, seed=0)
        devices = [lat.PAPER_DEVICES[i % 2] for i in range(4)]
        cuts = [lat.Cut(1, 3, 1, 3) if i % 2 else lat.Cut(2, 4, 2, 4)
                for i in range(4)]
        return clients, devices, cuts
    ref = jhuscf.HuSCFTrainer(*setup(jlat, jpart),
                              config=jhuscf.HuSCFConfig(batch=4))
    port = thuscf.HuSCFTrainer(*setup(tlat, tpart),
                               config=thuscf.HuSCFConfig(batch=4),
                               device="cpu")
    ref_np = jax.tree_util.tree_map(np.asarray, ref.state)
    port.state = state_from_numpy(ref_np, "cpu")
    return ref, port, ref_np


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def test_reference_trainer_checkpoint_loads_in_the_port(tmp_path,
                                                        trainer_pair):
    ref, port, ref_np = trainer_pair
    path = str(tmp_path / "ref.ckpt")
    jckpt.save_checkpoint(path, ref.state, step=7)
    template = state_to_numpy(port.state)
    assert tckpt.tree_flatten(template)[1] == str(
        jax.tree_util.tree_structure(ref.state))
    back, step = tckpt.load_checkpoint(path, template)
    assert step == 7
    got = tckpt.tree_flatten(back)[0]
    want = jax.tree_util.tree_leaves(ref_np)
    assert len(got) == len(want) > 100
    assert all(map(_same_bits, got, want))
    # and on into the port's layouts: the port's state, bit for bit
    restored = state_from_numpy(back, "cpu")
    for a, b in zip(tckpt.tree_flatten(restored)[0],
                    tckpt.tree_flatten(port.state)[0]):
        assert (torch.equal(a, b) and a.dtype == b.dtype
                if isinstance(b, torch.Tensor) else a == b)


def test_port_trainer_checkpoint_loads_in_the_reference(tmp_path,
                                                        trainer_pair):
    ref, port, ref_np = trainer_pair
    path = str(tmp_path / "port.ckpt")
    tckpt.save_checkpoint(path, state_to_numpy(port.state), step=9)
    back, step = jckpt.load_checkpoint(path, ref.state)
    assert step == 9
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(ref.state))
    got = jax.tree_util.tree_leaves(back)
    want = jax.tree_util.tree_leaves(ref_np)
    assert len(got) == len(want)
    assert all(_same_bits(np.asarray(a), b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# launcher and config surface
# ---------------------------------------------------------------------------

def test_launcher_takes_per_step(capsys):
    tr = ttrain.main(["--arch", "huscf-gan", "--device", "cpu", "--clients",
                      "4", "--base-size", "24", "--batch", "4", "--epochs",
                      "2", "--federate-every", "1", "--per-step"])
    out = capsys.readouterr().out
    assert "per-step epochs" in out and "eager" not in out
    assert len(tr.history) == 2 and not tr.cfg.fused_epoch


def test_config_takes_the_reference_fields():
    names = {f.name for f in dataclasses.fields(jhuscf.HuSCFConfig)}
    ported = {f.name for f in dataclasses.fields(thuscf.HuSCFConfig)}
    assert names <= ported
    cfg = thuscf.HuSCFConfig(fused_epoch=False, epoch_unroll=4,
                             split_program=True)
    thuscf._check_supported(cfg)
    assert thuscf.HuSCFConfig().fused_epoch is True
    assert jhuscf.HuSCFConfig().fused_epoch is True


@pytest.mark.parametrize("field,value,match", [
    ("split_program", False, "legacy hand-rolled")])
def test_config_values_the_port_cannot_honour_raise(field, value, match):
    clients = tpart.build_scenario("2dom_noniid", num_clients=2,
                                   base_size=8, seed=0)
    with pytest.raises(NotImplementedError, match=match):
        thuscf.HuSCFTrainer(clients,
                            config=thuscf.HuSCFConfig(**{field: value}),
                            device="cpu")
