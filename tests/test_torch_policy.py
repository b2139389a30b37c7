"""The port's sharding policy against the JAX package's, in one process and
without a process group: both read only a mesh's axis names and sizes,
so both run on the same stand-in meshes and must give equal specs.

Stand-ins: (data 1, model 1), (data 16, model 16), (pod 2, data 16,
model 16) (the reference's production meshes), the port's production
meshes (data 32, model 8) and (pod 2, data 32, model 8), and a 1-D
data mesh of 4. Specs compare entry by entry (both are tuples of None,
axis names and tuples of names). Parameter specs cover every leaf of
every LM arch's smoke parameters (the port keeps the reference's LM
tree) and of the split cGAN's serving state, whose conv kernels the
port keeps as OIHW and (I, O, kh, kw) where the reference keeps HWIO:
those are held to the reference's spec moved through ``bridge``'s
transposition.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.launch import serve_split as jss  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_smoke_config, list_archs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve_split as tss  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402


class StandInMesh:
    """What both policies read of a mesh: axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = collections.OrderedDict(zip(names, shape))


MESHES = {
    "host": StandInMesh((1, 1), ("data", "model")),
    "v5e_pod": StandInMesh((16, 16), ("data", "model")),
    "v5e_multipod": StandInMesh((2, 16, 16), ("pod", "data", "model")),
    "h100_pod": StandInMesh(*tmesh.PRODUCTION_SHAPES[False]),
    "h100_multipod": StandInMesh(*tmesh.PRODUCTION_SHAPES[True]),
    "data4": StandInMesh((4,), ("data",)),
}
POLICIES = [tpol.ShardingPolicy(),
            tpol.ShardingPolicy(fsdp=False, seq_parallel=False,
                                shard_cache_seq=False)]
KINDS = ("resid", "resid_inner", "tokens", "cache", "state", "logits",
         "rows", "other")


def _jpolicy(p):
    return jpol.ShardingPolicy(p.fsdp, p.seq_parallel, p.shard_cache_seq)


def test_production_meshes_are_256_and_512_ranks():
    for multi, n in ((False, 256), (True, 512)):
        shape, names = tmesh.PRODUCTION_SHAPES[multi]
        assert int(np.prod(shape)) == n and names[-1] == "model"
        assert dict(zip(names, shape))["model"] == 8


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_host_logic_matches_reference(mesh):
    m = MESHES[mesh]
    assert tpol.data_axes(m) == jpol.data_axes(m)
    specs = [("data",), ("model",), (("pod", "data"),), ("pod",),
             (None, "model"), (("data", "model"), None), ("nope",),
             ("data", "model", None)]
    for shape in [(1,), (8,), (16,), (32, 8), (64, 256, 3), (512, 7, 16),
                  (10, 12)]:
        for spec in specs:
            got = tpol.sanitize(m, shape, spec)
            want = jpol.sanitize(m, shape, spec)
            assert tuple(got) == tuple(want), (shape, spec)
    for n in list(range(1, 70)) + [256, 512, 1024, 1000]:
        assert tpol.client_axes(m, n) == jpol.client_axes(m, n)
        assert tuple(tpol.client_stack_spec(m, (n, 3))) == (
            jpol.client_axes(m, n), None)
    for sizes in ([4, 8, 16], [2, 8], [1], [16, 16, 16], [32, 64], [3, 5],
                  [64, 512], [12, 36]):
        assert tpol.group_client_axes(m, sizes) == \
            jpol.group_client_axes(m, sizes)
        assert tpol.cohort_axes(m, sizes) == jpol.cohort_axes(m, sizes)
    for p in POLICIES:
        for kind in KINDS:
            assert tuple(tpol.act_spec(m, p, kind)) == tuple(
                jpol.act_spec(m, _jpolicy(p), kind)), kind


def _lm_params(arch):
    """The reference's smoke params traced abstractly (shapes only) and
    the port's drawn on the CPU."""
    cfg_j = jsmoke(arch)
    want = jax.eval_shape(lambda k: jT.init_lm(k, cfg_j),
                          jax.random.PRNGKey(0))
    got = tT.init_lm(get_smoke_config(arch), torch.Generator().manual_seed(0),
                     "cpu")
    return got, want


def _spec_leaves(tree):
    return jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, (jpol.P, tpol.PartitionSpec)))[0]


@pytest.mark.parametrize("arch", list_archs())
def test_lm_param_specs_match_reference(arch):
    got_params, want_params = _lm_params(arch)
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
        want_params)[0]]
    n_sharded = 0
    for mesh in ("host", "v5e_pod", "v5e_multipod", "h100_pod",
                 "h100_multipod"):
        m = MESHES[mesh]
        for p in POLICIES:
            want = _spec_leaves(jpol.tree_param_specs(m, _jpolicy(p),
                                                      want_params))
            got = _spec_leaves(tpol.tree_param_specs(m, p, got_params))
            assert len(got) == len(want) == len(paths)
            for path, g, w in zip(paths, got, want):
                assert tuple(g) == tuple(w), (mesh, jax.tree_util.keystr(path))
                n_sharded += any(e is not None for e in g)
    assert n_sharded > 0


def _bridge_perm(kind, ndim):
    """Where ``bridge`` puts each reference-layout dim of a conv kernel:
    port dim i holds reference dim perm[i]."""
    shape = tuple(range(2, 2 + ndim))           # distinct sizes
    moved = bridge._hwio_to_port(np.zeros(shape, np.float32), kind)
    return [shape.index(s) for s in moved.shape]


def test_gan_param_specs_match_reference_through_bridge():
    """The split cGAN's client and server params (the trainer's layout):
    every leaf's spec equals the reference's, a conv kernel's moved to
    the port's layout."""
    groups_j, groups_t = jss.build_mix("balanced"), tss.build_mix("balanced")
    want_c, want_s = jax.eval_shape(
        lambda k: jss.init_gan_serving_state(k, groups_j),
        jax.random.PRNGKey(0))
    got_c, got_s = tss.init_gan_serving_state(
        torch.Generator().manual_seed(0), groups_t, device="cpu")
    n_conv = 0
    for mesh in ("host", "v5e_pod", "h100_pod", "h100_multipod", "data4"):
        m = MESHES[mesh]
        for p in POLICIES:
            for got_tree, want_tree in ((got_c, want_c), (got_s, want_s)):
                want = jpol.tree_param_specs(m, _jpolicy(p), want_tree)
                flat = jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(x, jpol.P))[0]
                got = tpol.tree_param_specs(m, p, got_tree)
                for path, w in flat:
                    keys = [k.key for k in path]
                    g = got
                    for k in keys:
                        g = g[k]
                    kind = bridge._kind(tuple(keys))
                    if kind == "plain":
                        assert tuple(g) == tuple(w), keys
                        continue
                    n_conv += 1
                    perm = _bridge_perm(kind, len(w))
                    assert tuple(g) == tuple(w[i] for i in perm), keys
    assert n_conv > 0


def test_placements_and_maybe_shard():
    """Specs map onto DTensor placements per mesh dim; ``maybe_shard`` is
    the identity on a plain tensor, outside a context, and leaves a
    DTensor on a 1-rank mesh replicated."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    m = MESHES["h100_multipod"]
    assert tpol.to_placements(m, tpol.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert tpol.to_placements(m, tpol.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    assert tpol.client_stack_sharding(MESHES["data4"], (8, 3)) == (Shard(0),)
    assert tpol.client_stack_sharding(MESHES["data4"], (6, 3)) == (
        Replicate(),)
    tree = {"blocks": [{"attn": {"wq": torch.zeros(64, 8, 16)}}],
            "embed": {"table": torch.zeros(256, 64)}}
    placements = tpol.tree_shardings(MESHES["h100_pod"], tpol.ShardingPolicy(),
                                     tree)
    assert placements["blocks"][0]["attn"]["wq"] == (Shard(0), Shard(1))
    assert placements["embed"]["table"] == (Shard(1), Shard(0))
    x = torch.arange(12.0).reshape(4, 3)
    assert tpol.maybe_shard(x, "rows") is x
    host = tmesh.make_host_mesh()
    with tpol.activation_sharding(host, None):
        assert tpol.maybe_shard(x, "rows") is x
        d = distribute_tensor(x, host, [Replicate(), Replicate()])
        out = tpol.maybe_shard(d, "rows")
        assert isinstance(out, DTensor)
        assert out.placements == (Replicate(), Replicate())
        assert torch.equal(out.full_tensor(), x)
    with tpol.activation_sharding(None, None):
        assert tpol.maybe_shard(x, "rows") is x
