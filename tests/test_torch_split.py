"""Host-side logic and split execution of the port against the JAX
package: the latency model, the host GA, profile groups, the compiled
SplitProgram tables and the split executor, and the data modules.

Host logic must match exactly: latency to 1e-12, the GA's result
field by field, program tables and seeded datasets byte for byte. The
executor's activations match to float32 convolution noise (1e-4), its
captured middles and BatchNorm statistics to 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import genetic as jgen  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import segments as jseg  # noqa: E402
from repro.core import splitting as jspl  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.launch.serve_split import init_gan_serving_state  # noqa: E402
from repro_torch.bridge import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.core import genetic as tgen  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.core import splitting as tspl  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

# a 3-group cut mix: weak/medium/strong devices with different cuts
MIX = [(0, (1, 4, 1, 4), 2), (1, (2, 3, 2, 3), 3), (2, (1, 3, 2, 4), 1)]


def _population(lib):
    devices, cuts = [], []
    for dev, cut, n in MIX:
        devices += [lib.PAPER_DEVICES[dev]] * n
        cuts += [lib.Cut(*cut)] * n
    return devices, cuts


def _plain(x):
    """Dataclass (or tuple of them) -> nested tuples, for comparing the
    two packages' objects field by field."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name))
                     for f in dataclasses.fields(x))
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    return x


def random_split_state(groups, net, seed):
    """(client, server) params in the reference's layout for ``groups``,
    drawn with numpy: the shapes come from the reference's initializer
    (traced abstractly, which is much cheaper than running it), the
    values from a seed. BN scales and variances stay positive."""
    shapes = jax.eval_shape(
        lambda k: init_gan_serving_state(k, groups, net=net),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("mean", "bias", "b"):
            a = rng.normal(0, 0.1, leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[-3:-1])) if leaf.ndim >= 4 \
                else leaf.shape[-2]
            a = rng.normal(0, 1.0 / np.sqrt(fan_in), leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_latency_model_matches_reference():
    rng = np.random.default_rng(0)
    opts_j, opts_t = jlat.all_cut_options(), tlat.all_cut_options()
    assert [c.as_tuple() for c in opts_j] == [c.as_tuple() for c in opts_t]
    for trial in range(20):
        n = int(rng.integers(1, 12))
        devs = rng.integers(0, 7, n)
        picks = rng.integers(0, len(opts_j), n)
        batch = int(rng.choice([16, 64]))
        want = jlat.huscf_iteration_latency(
            [opts_j[i] for i in picks], [jlat.PAPER_DEVICES[d] for d in devs],
            jlat.PAPER_SERVER, batch)
        got = tlat.huscf_iteration_latency(
            [opts_t[i] for i in picks], [tlat.PAPER_DEVICES[d] for d in devs],
            tlat.PAPER_SERVER, batch)
        assert abs(got - want) <= 1e-12 * abs(want)


def test_host_ga_is_identical():
    devices_j = [jlat.PAPER_DEVICES[i % 7] for i in range(8)]
    devices_t = [tlat.PAPER_DEVICES[i % 7] for i in range(8)]
    kw = dict(population_size=60, generations=12, seed=3)
    want = jgen.optimize_cuts(devices_j, batch=16,
                              config=jgen.GAConfig(fused=False, **kw))
    got = tgen.optimize_cuts(devices_t, batch=16,
                             config=tgen.GAConfig(fused=False, **kw))
    assert [c.as_tuple() for c in got.cuts] == [c.as_tuple()
                                                 for c in want.cuts]
    assert got.latency == want.latency
    assert got.history == want.history
    assert (got.generations_run, got.convergence_gen) == (
        want.generations_run, want.convergence_gen)
    # at the paper's protocol (population 1000, 60 generations) the port's
    # fused search, from its own torch draws, returns the cuts of the
    # reference's fused search on this mix
    ref = jgen.optimize_cuts(devices_j, batch=16,
                             config=jgen.GAConfig(fused=True, seed=3))
    fused = tgen.optimize_cuts(devices_t, batch=16, fused=True,
                               config=tgen.GAConfig(seed=3), device="cpu")
    assert [c.as_tuple() for c in fused.cuts] == [c.as_tuple()
                                                   for c in ref.cuts]
    assert fused.latency == ref.latency


def test_profile_groups_and_programs_match():
    dj, cj = _population(jlat)
    dt, ct = _population(tlat)
    gj, gt = jspl.group_by_profile(dj, cj), tspl.group_by_profile(dt, ct)
    assert [(g.name, g.client_ids) for g in gj] == [(g.name, g.client_ids)
                                                    for g in gt]
    for net in ("G", "D"):
        assert tspl.server_union_span(gt, net, 5) == jspl.server_union_span(
            gj, net, 5)
        assert _plain(tseg.compile_split_program(gt, net)) == _plain(
            jseg.compile_split_program(gj, net))
    assert [tspl.bucket_size(n) for n in range(9)] == [
        jspl.bucket_size(n) for n in range(9)]


@pytest.mark.parametrize("net", ["G", "D"])
def test_split_executor_matches_reference(net):
    """make_apply: outputs, captured middles (D) and the BatchNorm
    updates of heads (per client), server steps (population-wide) and
    tails, from one set of weights in train mode."""
    dj, cj = _population(jlat)
    dt, ct = _population(tlat)
    gj, gt = jspl.group_by_profile(dj, cj), tspl.group_by_profile(dt, ct)
    client, server = random_split_state(gj, net, seed=0)
    rng = np.random.default_rng(1)
    inputs = {}
    for g in gj:
        y = rng.integers(0, 10, (g.size, 2)).astype(np.int32)
        first = ((g.size, 2, 100) if net == "G"
                 else (g.size, 2, 28, 28, 1))
        inputs[g.name] = (rng.normal(size=first).astype(np.float32), y)
    capture = net == "D"
    out_j, nc_j, ns_j, mid_j = jax.jit(
        jseg.make_apply(jseg.compile_split_program(gj, net),
                        capture_middle=capture), static_argnums=3)(
        client, server,
        {k: tuple(map(jnp.asarray, v)) for k, v in inputs.items()}, True)
    out_t, nc_t, ns_t, mid_t = tseg.make_apply(
        tseg.compile_split_program(gt, net), capture_middle=capture)(
        state_from_numpy(client, "cpu"), state_from_numpy(server, "cpu"),
        {k: tuple(map(torch.from_numpy, v)) for k, v in inputs.items()},
        True)
    for g in gj:
        np.testing.assert_allclose(out_t[g.name].numpy(),
                                   np.asarray(out_j[g.name]), rtol=1e-4,
                                   atol=1e-4)
    if capture:
        assert set(mid_t) == set(mid_j)
        for name in mid_j:
            assert mid_t[name].shape == (mid_j[name].shape[0], 6272)
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


def test_datasets_are_byte_identical():
    for dom in jsyn.DOMAINS:
        ij, lj = jsyn.make_dataset(dom, 40, seed=5)
        it, lt = tsyn.make_dataset(dom, 40, seed=5)
        assert ij.tobytes() == it.tobytes() and lj.tobytes() == lt.tobytes()
    for name in ("2dom_noniid", "1dom_noniid"):
        cj = jpart.build_scenario(name, num_clients=6, base_size=20, seed=1)
        ct = tpart.build_scenario(name, num_clients=6, base_size=20, seed=1)
        assert len(cj) == len(ct)
        for a, b in zip(cj, ct):
            assert (a.client_id, a.domain) == (b.client_id, b.domain)
            assert a.images.tobytes() == b.images.tobytes()
            assert a.labels.tobytes() == b.labels.tobytes()


def test_sample_batch_never_reads_padding():
    """Padded rows carry a -1 label; the sampler draws indices below
    each client's count, so no batch may contain one."""
    rng = np.random.default_rng(0)
    sizes = [3, 9, 5, 9]
    clients = [tpart.ClientSpec(i, "gratings",
                                rng.normal(size=(n, 28, 28, 1))
                                .astype(np.float32),
                                rng.integers(0, 10, n).astype(np.int32))
               for i, n in enumerate(sizes)]
    groups = tspl.group_by_profile([tlat.PAPER_DEVICES[0]] * 4,
                                   [tlat.Cut(1, 3, 1, 3)] * 4)
    ds = tpipe.stage_clients(groups, clients, "cpu")
    (gname,) = ds.order
    assert tuple(ds.images[gname].shape) == (4, 9, 28, 28, 1)
    assert int((ds.labels[gname] == -1).sum()) == sum(9 - n for n in sizes)
    gen = torch.Generator().manual_seed(0)
    for _ in range(8):
        batch = tpipe.sample_batch(ds, gen, batch=16, z_dim=100,
                                   num_classes=10)
        y = batch["real_y"][gname]
        assert tuple(y.shape) == (4, 16)
        assert bool((y >= 0).all()), "sampler read a padded row"
        assert tuple(batch["z"][gname].shape) == (4, 16, 100)
        assert bool(((batch["fake_y"][gname] >= 0)
                     & (batch["fake_y"][gname] < 10)).all())


def test_host_ga_picks_the_fused_reference_cuts_on_the_default_mix():
    """The launcher's default population (8 clients on the paper's 7
    device profiles, batch 16, the trainer's GA settings): the port's
    host GA and the reference's fused device GA pick the same cuts."""
    kw = dict(population_size=200, generations=30, seed=0)
    fused = jgen.optimize_cuts([jlat.PAPER_DEVICES[i % 7] for i in range(8)],
                               batch=16, config=jgen.GAConfig(fused=True,
                                                              **kw))
    port = tgen.optimize_cuts([tlat.PAPER_DEVICES[i % 7] for i in range(8)],
                              batch=16, config=tgen.GAConfig(fused=False,
                                                             **kw))
    assert [c.as_tuple() for c in port.cuts] == [c.as_tuple()
                                                  for c in fused.cuts]
    assert port.latency == fused.latency
