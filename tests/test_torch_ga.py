"""The fused GA cut search of the port against the JAX package: the
batched latency model (``core.latency_device`` against
``repro.core.latency_jax`` and the host float64 model), the Eq. 7/8
recurrence, the program latency, the host coordinate-descent bound, the
GA's bookkeeping, and the search itself fed the reference's own
``jax.random`` draws.

Tolerances: the batched model rounds float64 tables once to float32
and does a handful of float32 adds and maxes, so it agrees with the
host float64 model to 1e-6 relative (the reference's own bound) and
with the reference's float32 model to the same; the Eq. 7/8 recurrence
runs the same float32 operations in the same order, so it is equal; the
program latency is host float64 in both (1e-12 relative). A search fed
the same draws must take the same path: equal winner, convergence
generation and generations run, history to 1e-6 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import genetic as jgen  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core import latency_jax as jlj  # noqa: E402
from repro.core import segments as jseg  # noqa: E402
from repro.core import splitting as jspl  # noqa: E402
from repro_torch.core import genetic as tgen  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core import latency_device as tld  # noqa: E402
from repro_torch.core import segments as tseg  # noqa: E402
from repro_torch.core import splitting as tspl  # noqa: E402

REL_TOL = 1e-6
OPTIONS = tlat.all_cut_options()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def paper_mix(lat, n=100, seed=0):
    """The paper's device mix: ``n`` clients drawn uniformly over the 7
    profiles of Table 4 (``benchmarks/latency_table.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    return [lat.PAPER_DEVICES[i] for i in rng.integers(0, 7, n)]


# ---------------------------------------------------------------------------
# the batched latency model
# ---------------------------------------------------------------------------

def _assignments(n_clients, rng):
    """Every same-option assignment plus 50 seeded per-client mixes."""
    same = [np.full(n_clients, o, np.int64) for o in range(len(OPTIONS))]
    return np.stack(same + [rng.integers(0, len(OPTIONS), n_clients)
                            for _ in range(50)])


@pytest.mark.parametrize("with_counts", [False, True])
@pytest.mark.parametrize("n_clients", [1, 3, 7])
def test_population_latency_matches_reference_and_host(n_clients,
                                                       with_counts):
    rng = np.random.default_rng(1234 + n_clients)
    kinds = [i % 7 for i in range(n_clients)]
    pop = _assignments(n_clients, rng)
    counts = (rng.integers(1, 6, n_clients).astype(np.float32)
              if with_counts else None)
    t_tab = tld.build_latency_tables([tlat.PAPER_DEVICES[k] for k in kinds],
                                     tlat.PAPER_SERVER, 64, device="cpu")
    j_tab = jlj.build_latency_tables([jlat.PAPER_DEVICES[k] for k in kinds],
                                     jlat.PAPER_SERVER, 64)
    got = tld.population_latency(
        t_tab, torch.from_numpy(pop),
        None if counts is None else torch.from_numpy(counts)).numpy()
    want = np.asarray(jlj.population_latency(
        j_tab, jnp.asarray(pop, jnp.int32),
        None if counts is None else jnp.asarray(counts)))
    assert got.dtype == np.float32 and got.shape == (len(pop),)
    assert _rel(got, want) < REL_TOL
    # the host float64 model over the population the counts stand for
    reps = (np.ones(n_clients, np.int64) if counts is None
            else counts.astype(np.int64))
    devices = [tlat.PAPER_DEVICES[k] for k, r in zip(kinds, reps)
               for _ in range(r)]
    host = [tlat.huscf_iteration_latency(
        [OPTIONS[o] for o, r in zip(ind, reps) for _ in range(r)], devices,
        tlat.PAPER_SERVER, 64) for ind in pop]
    assert _rel(got, host) < REL_TOL
    one = tld.huscf_iteration_latency_dev(
        t_tab, torch.from_numpy(pop[-1]),
        None if counts is None else torch.from_numpy(counts))
    assert float(one) == got[-1]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lead", [(), (37,), (4, 9)])
def test_join_barrier_scan_matches_reference(lead, reverse):
    rng = np.random.default_rng(len(lead) + 10 * reverse)
    terms = rng.uniform(0, 2, lead + (5,)).astype(np.float32)
    bars = rng.uniform(0, 6, lead + (5,)).astype(np.float32)
    got = tseg.join_barrier_scan(torch.from_numpy(terms),
                                 torch.from_numpy(bars), reverse=reverse)
    fn = lambda a, b: jseg.join_barrier_scan(a, b, reverse=reverse)
    for _ in lead:
        fn = jax.vmap(fn)
    want = np.asarray(fn(jnp.asarray(terms), jnp.asarray(bars)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_iteration_latency_matches_reference(seed):
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 7, 9)
    picks = rng.integers(0, len(OPTIONS), 7)
    opts_j = jlat.all_cut_options()
    progs = []
    for lat, spl, seg, opts in ((jlat, jspl, jseg, opts_j),
                                (tlat, tspl, tseg, OPTIONS)):
        devices = [lat.PAPER_DEVICES[k] for k in kinds]
        cuts = [opts[picks[k]] for k in kinds]
        groups = spl.group_by_profile(devices, cuts)
        profiles = {g.name: g.profile for g in groups}
        progs.append(seg.program_iteration_latency(
            seg.compile_split_program(groups, "G"),
            seg.compile_split_program(groups, "D"), profiles,
            lat.PAPER_SERVER, 64))
    want, got = progs
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("n,seed", [(4, 0), (6, 1), (9, 2)])
def test_exhaustive_profile_optimum_is_identical(n, seed):
    cuts_j, lat_j = jgen.exhaustive_profile_optimum(paper_mix(jlat, n, seed),
                                                    batch=64)
    cuts_t, lat_t = tgen.exhaustive_profile_optimum(paper_mix(tlat, n, seed),
                                                    batch=64)
    assert [c.as_tuple() for c in cuts_t] == [c.as_tuple() for c in cuts_j]
    assert lat_t == lat_j


def test_profile_reduction_rejects_conflicting_specs():
    d0 = tlat.PAPER_DEVICES[0]
    clash = tlat.DeviceProfile(d0.name, d0.freq_hz * 2, d0.flops_per_cycle,
                               d0.rate_bytes_per_s)
    with pytest.raises(ValueError, match="different specs"):
        tgen.CutSearcher([d0, clash], batch=64, device="cpu")
    # without the collapse the two are separate genes
    s = tgen.CutSearcher([d0, clash], batch=64, device="cpu",
                         config=tgen.GAConfig(profile_based=False))
    assert s.n_genes == 2


# ---------------------------------------------------------------------------
# the GA's bookkeeping
# ---------------------------------------------------------------------------

CFG = tgen.GAConfig(population_size=200, generations=25, seed=0,
                    early_stop_patience=10)


@pytest.mark.parametrize("generations", [0, 25])
@pytest.mark.parametrize("fused", [False, True])
def test_history_convention(fused, generations):
    """history[0] is the initial population's best, there are
    generations_run + 1 entries and history[convergence_gen] is the
    final best; with generations = 0 the initial population is the
    answer."""
    devices = paper_mix(tlat, 30)
    cfg = dataclasses.replace(CFG, generations=generations)
    res = tgen.optimize_cuts(devices, batch=64, config=cfg, fused=fused,
                             device="cpu")
    assert len(res.history) == res.generations_run + 1
    assert 0 <= res.convergence_gen <= res.generations_run <= generations
    assert np.isclose(min(res.history), res.history[res.convergence_gen],
                      rtol=1e-6)
    assert np.isclose(res.history[res.convergence_gen], res.latency,
                      rtol=1e-6)
    assert np.isclose(res.latency, tlat.huscf_iteration_latency(
        res.cuts, devices, tlat.PAPER_SERVER, 64))
    if generations == 0:
        assert (res.generations_run, res.convergence_gen) == (0, 0)


def test_fused_search_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.optimize_cuts(paper_mix(tlat, 5), batch=64)
    assert tgen.GAConfig().fused is True


# ---------------------------------------------------------------------------
# the fused search fed the reference's draws
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_generation_draws(P, n_genes, n_opt, tournament, crossover_rate,
                                mutation_rate, elitism):
    """Jitted ``k -> (keys[0], draws)`` of one reference generation."""
    n_elite = max(0, min(elitism, P - 1))
    n_child = P - n_elite
    n_pairs = (n_child + 1) // 2
    u = jax.random.uniform

    @jax.jit
    def one(k):
        k = jax.random.split(k, 8)
        return k[0], (
            jax.random.randint(k[1], (2, n_pairs, tournament), 0, P),
            u(k[2], (n_pairs, 1)) < crossover_rate,
            u(k[3], (n_pairs, 1)) < 0.5,
            u(k[4], (n_pairs, n_genes)) < 0.5,
            jnp.sort(jax.random.randint(k[5], (n_pairs, 2), 0, n_genes),
                     axis=1),
            u(k[6], (n_child, n_genes)) < mutation_rate,
            jax.random.randint(k[7], (n_child, n_genes), 0, n_opt))
    return one


def reference_draws(key, cfg, n_genes, n_opt):
    """The initial population and a ``draws(g)`` callable that make the
    reference's ``jax.random`` draws by its own recipe
    (``repro.core.genetic._get_search_fn``): ``k_init, k_loop =
    split(key)``, then per generation ``keys = split(k, 8)`` with
    ``keys[0]`` carried forward."""
    P = cfg.population_size
    one = _reference_generation_draws(
        P, n_genes, n_opt, cfg.tournament_size, float(cfg.crossover_rate),
        float(cfg.mutation_rate), cfg.elitism)
    k_init, k_loop = jax.random.split(key)
    init = jax.random.randint(k_init, (P, n_genes), 0, n_opt, jnp.int32)
    chain = [k_loop]

    def draws(g):
        assert g == len(chain) - 1, "generations are drawn in order"
        nxt, d = one(chain[g])
        chain.append(nxt)
        return tgen.Draws(*(torch.from_numpy(np.array(x)) for x in d))

    return torch.from_numpy(np.array(init)), draws


def _searchers(cfg, n_clients, seed):
    """Both packages' searchers on one seeded order of ``n_clients``
    clients over all 7 profiles (7 genes under the profile collapse, so
    the reference compiles one search per configuration)."""
    kinds = np.random.default_rng(seed).permutation(n_clients) % 7
    devices_j = [jlat.PAPER_DEVICES[k] for k in kinds]
    devices_t = [tlat.PAPER_DEVICES[k] for k in kinds]
    jcfg = jgen.GAConfig(**dataclasses.asdict(cfg))
    return (jgen.CutSearcher(devices_j, batch=64, config=jcfg),
            tgen.CutSearcher(devices_t, batch=64, config=cfg, device="cpu"))


@pytest.mark.parametrize("profile_based", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_search_fed_reference_draws_takes_reference_path(seed,
                                                               profile_based):
    cfg = tgen.GAConfig(population_size=120, generations=20, seed=seed,
                        early_stop_patience=8, profile_based=profile_based)
    js, ts = _searchers(cfg, 9, seed)
    key = jax.random.PRNGKey(seed)
    init, draws = reference_draws(key, cfg, ts.n_genes, len(ts.options))
    want = js.run(key)
    got = ts.run(None, init_pop=init, draws=draws)
    np.testing.assert_array_equal(got.best_ind.numpy(),
                                  np.asarray(want.best_ind))
    assert int(got.convergence_gen) == int(want.convergence_gen)
    assert int(got.generations_run) == int(want.generations_run)
    h_t, h_j = got.history.numpy(), np.asarray(want.history)
    n = int(want.generations_run) + 1
    assert _rel(h_t[:n], h_j[:n]) < REL_TOL
    assert np.isnan(h_t[n:]).all() and np.isnan(h_j[n:]).all()
    assert _rel(float(got.best_latency), float(want.best_latency)) < REL_TOL
    # and the read-back result is the reference's
    r_t, r_j = ts.to_result(got), js.to_result(want)
    assert [c.as_tuple() for c in r_t.cuts] == [c.as_tuple()
                                                 for c in r_j.cuts]
    assert r_t.latency == r_j.latency


def test_fused_search_fed_reference_draws_stops_on_patience():
    """A small population on the 7 profiles converges early, so the
    patience (3) ends the search well before its 40 generations."""
    cfg = tgen.GAConfig(population_size=64, generations=40, seed=5,
                        early_stop_patience=3)
    js, ts = _searchers(cfg, 20, 5)
    key = jax.random.PRNGKey(5)
    init, draws = reference_draws(key, cfg, ts.n_genes, len(ts.options))
    want = js.run(key)
    got = ts.run(None, init_pop=init, draws=draws)
    assert int(want.generations_run) < cfg.generations
    assert int(got.generations_run) == int(want.generations_run)
    assert int(got.convergence_gen) == int(want.convergence_gen)
    np.testing.assert_array_equal(got.best_ind.numpy(),
                                  np.asarray(want.best_ind))
    n = int(want.generations_run) + 1
    assert _rel(got.history.numpy()[:n], np.asarray(want.history)[:n]) \
        < REL_TOL
    assert np.isnan(got.history.numpy()[n:]).all()


def test_fused_search_no_worse_than_host_oracle_on_paper_mix():
    """The paper's protocol (population 1000, 60 generations, patience
    15, seed 0) on the paper's 100-client mix: the port's own fused
    search on the CPU is no worse than its host oracle."""
    devices = paper_mix(tlat)
    cfg = tgen.GAConfig()
    host = tgen.optimize_cuts(devices, batch=64, config=cfg, fused=False)
    fused = tgen.optimize_cuts(devices, batch=64, config=cfg, device="cpu")
    assert fused.latency <= host.latency + 1e-9
    assert np.isclose(fused.latency, tlat.huscf_iteration_latency(
        fused.cuts, devices, tlat.PAPER_SERVER, 64))
