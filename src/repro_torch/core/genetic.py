"""Genetic algorithm for cut-point selection — paper §4.3 + App. D (port
of ``repro.core.genetic``).

Minimizes ``huscf_iteration_latency`` over the joint per-client cut
vector with the paper's operators: tournament selection (size 5),
uniform and two-point crossover alternated 50/50 with probability
``crossover_rate``, per-gene mutation, elitism (top 2 carried over), and
the appendix-D profile reduction (one gene per device profile).

Two execution paths, as in the reference:

* ``GAConfig.fused=True`` (the default): the search runs on the device.
  Fitness is the batched Eq. 3-10 model (``core.latency_device``) over
  the whole ``[P, n_genes]`` population at once, collapsed to the unique
  profiles with a client-count vector. Each generation (tournament
  gathers and argmax, 50/50 uniform/two-point crossover, per-gene
  mutation, elitism by a stable descending sort, so that ties go to the
  lower index as ``lax.top_k`` sends them) is a handful of tensor ops.
  The reference's ``while_loop`` exits on the early-stop patience; here
  every search runs a fixed trip of ``generations`` steps and a device
  flag freezes every carried value once the search has stalled, so a
  search makes no host synchronisation. ``CutSearcher`` holds the staged
  tables, so a re-optimization costs one ``run`` per round.
* ``GAConfig.fused=False``: the host numpy loop, one scalar fitness call
  per individual per generation, kept as the solution-quality oracle. It
  draws from ``np.random.default_rng(seed)`` exactly as the reference's
  host path does, so the same config returns the same ``GAResult``.

Random draws are separate from the operators: ``draw_initial`` and
``draw_generation`` take a ``torch.Generator`` on the search's device,
and ``CutSearcher.run`` takes an initial population and a draws callable
in their place, so that the tests can feed it the reference's
``jax.random`` draws.

Bookkeeping convention (both paths): ``history[g]`` is generation g's
best latency with g = 0 the initial population, so ``history`` has
``generations_run + 1`` entries; ``convergence_gen`` is the generation
whose population first held the final best individual (0: the initial
population did).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.latency import (Cut, DeviceProfile, PAPER_SERVER,
                                      all_cut_options,
                                      huscf_iteration_latency)
from repro_torch.core.latency_device import (LatencyTables,
                                             build_latency_tables,
                                             population_latency)


@dataclasses.dataclass
class GAConfig:
    population_size: int = 1000
    generations: int = 60
    crossover_rate: float = 0.7
    mutation_rate: float = 0.01
    tournament_size: int = 5
    elitism: int = 2
    profile_based: bool = True
    seed: int = 0
    early_stop_patience: int = 15
    fused: bool = True           # search on the device; False = host
    #                              numpy oracle (identical operators,
    #                              scalar fitness per individual)


@dataclasses.dataclass
class GAResult:
    cuts: List[Cut]            # per client
    latency: float
    generations_run: int
    convergence_gen: int       # generation that first held the final best
    #                            (0 = already in the initial population)
    history: List[float]       # per-generation best, history[0] = gen 0


def _profile_reduction(devices: Sequence[DeviceProfile],
                       profile_based: bool
                       ) -> Tuple[Optional[np.ndarray], int]:
    """Appendix D: collapse clients with identical profiles to one gene."""
    if not profile_based:
        return None, len(devices)
    names = [d.name for d in devices]
    uniq = sorted(set(names))
    profile_idx = {nm: i for i, nm in enumerate(uniq)}
    return np.array([profile_idx[nm] for nm in names]), len(uniq)


def _upsample_cuts(ind: np.ndarray, profile_of: Optional[np.ndarray],
                   n_clients: int, options: List[Cut]) -> List[Cut]:
    if profile_of is not None:
        return [options[ind[profile_of[k]]] for k in range(n_clients)]
    return [options[g] for g in ind]


# ---------------------------------------------------------------------------
# fused search on the device
# ---------------------------------------------------------------------------

class SearchOut(NamedTuple):
    """Device-tensor result of one fused GA run (read back at will)."""
    best_ind: torch.Tensor         # [n_genes] int64 option indices
    best_latency: torch.Tensor     # float32 scalar
    convergence_gen: torch.Tensor  # int64 scalar
    generations_run: torch.Tensor  # int64 scalar
    history: torch.Tensor          # [generations + 1] float32, NaN tail


class Draws(NamedTuple):
    """The random tensors of one generation, with the reference's shapes
    and ranges (``n_pairs = ceil(n_child / 2)``, ``n_child =
    population - elite``)."""
    t_idx: torch.Tensor          # [2, n_pairs, tournament] in [0, P)
    do_cross: torch.Tensor       # [n_pairs, 1] bool, p = crossover_rate
    use_uniform: torch.Tensor    # [n_pairs, 1] bool, p = 0.5
    umask: torch.Tensor          # [n_pairs, n_genes] bool, p = 0.5
    pts: torch.Tensor            # [n_pairs, 2] in [0, n_genes), sorted
    mmask: torch.Tensor          # [n_child, n_genes] bool, p = mutation_rate
    mvals: torch.Tensor          # [n_child, n_genes] in [0, n_opt)


def _n_elite_child(config: GAConfig) -> Tuple[int, int]:
    n_elite = max(0, min(config.elitism, config.population_size - 1))
    return n_elite, config.population_size - n_elite


def draw_initial(gen: torch.Generator, config: GAConfig, n_genes: int,
                 n_opt: int) -> torch.Tensor:
    """The initial population ``[P, n_genes]`` from ``gen``, uniform
    over the options."""
    return torch.randint(0, n_opt, (config.population_size, n_genes),
                         generator=gen, device=gen.device)


def draw_generation(gen: torch.Generator, config: GAConfig, n_genes: int,
                    n_opt: int) -> Draws:
    """One generation's draws from ``gen`` on its device."""
    _, n_child = _n_elite_child(config)
    n_pairs = (n_child + 1) // 2
    kw = dict(generator=gen, device=gen.device)
    return Draws(
        t_idx=torch.randint(0, config.population_size,
                            (2, n_pairs, config.tournament_size), **kw),
        do_cross=torch.rand((n_pairs, 1), **kw) < config.crossover_rate,
        use_uniform=torch.rand((n_pairs, 1), **kw) < 0.5,
        umask=torch.rand((n_pairs, n_genes), **kw) < 0.5,
        pts=torch.sort(torch.randint(0, n_genes, (n_pairs, 2), **kw),
                       dim=1).values,
        mmask=torch.rand((n_child, n_genes), **kw) < config.mutation_rate,
        mvals=torch.randint(0, n_opt, (n_child, n_genes), **kw))


def generation(pop: torch.Tensor, fits: torch.Tensor, d: Draws,
               config: GAConfig) -> torch.Tensor:
    """The next population from ``pop [P, G]`` and its fitness ``[P]``
    (higher is better): elitism, tournament selection, crossover and
    mutation, with the randomness taken from ``d``."""
    n_elite, n_child = _n_elite_child(config)
    # elitism: the best rows carried over unmodified; a stable sort puts
    # the lower index first among equal fitnesses, as lax.top_k does
    elite_rows = torch.sort(fits, descending=True, stable=True).indices
    elite = pop[elite_rows[:n_elite]]
    # tournament selection: index gathers + argmax (the first maximum),
    # two independent parents per pair
    win = torch.gather(d.t_idx, -1,
                       torch.argmax(fits[d.t_idx], -1, keepdim=True))[..., 0]
    p1, p2 = pop[win[0]], pop[win[1]]                      # [n_pairs, G]
    # 50/50 uniform / two-point crossover, applied with probability
    # crossover_rate per pair: a gene-swap mask either way
    gene_idx = torch.arange(pop.shape[1], device=pop.device)[None, :]
    tmask = (gene_idx >= d.pts[:, :1]) & (gene_idx <= d.pts[:, 1:])
    swap = d.do_cross & torch.where(d.use_uniform, d.umask, tmask)
    children = torch.cat([torch.where(swap, p2, p1),
                          torch.where(swap, p1, p2)], 0)[:n_child]
    # per-gene mutation
    children = torch.where(d.mmask, d.mvals, children)
    return torch.cat([elite, children], 0)


def search(tables: LatencyTables, counts: Optional[torch.Tensor],
           config: GAConfig, init_pop: torch.Tensor,
           draws: Callable[[int], Draws]) -> SearchOut:
    """The fused GA from ``init_pop [P, n_genes]``; ``draws(g)`` gives
    the draws that make generation g + 1 from generation g.

    Runs a fixed trip of ``config.generations`` steps. ``active`` (a
    device flag) turns false once ``early_stop_patience`` generations in
    a row found nothing better, and from then on every carried value
    stays as it was: the result is the reference's ``while_loop``'s,
    with no readback to the host inside the loop."""
    dev = init_pop.device
    steps = torch.arange(config.generations + 1, device=dev)

    def fitness(pop):
        return -population_latency(tables, pop, counts)

    pop = init_pop.long()
    fits = fitness(pop)
    # rows picked with index tensors, never a 0-dim index (which torch
    # reads back to the host)
    best_ind = pop.index_select(0, torch.argmax(fits).view(1))[0]
    best_fit = fits.max()
    hist = torch.where(steps == 0, -best_fit,
                       torch.full_like(steps, float("nan"),
                                       dtype=torch.float32))
    conv = torch.zeros((), dtype=torch.int64, device=dev)
    stall = torch.zeros_like(conv)
    gen = torch.zeros_like(conv)
    for g in range(config.generations):
        active = stall < config.early_stop_patience
        new_pop = generation(pop, fits, draws(g), config)
        new_fits = fitness(new_pop)
        gen_best = new_fits.max()
        improved = gen_best > best_fit + 1e-12
        adopt = active & improved
        best_fit = torch.where(adopt, gen_best, best_fit)
        best_ind = torch.where(
            adopt, new_pop.index_select(0, torch.argmax(new_fits).view(1))[0],
            best_ind)
        conv = torch.where(adopt, gen + 1, conv)
        stall = torch.where(active, torch.where(improved, 0, stall + 1),
                            stall)
        hist = torch.where(active & (steps == gen + 1), -gen_best, hist)
        pop = torch.where(active, new_pop, pop)
        fits = torch.where(active, new_fits, fits)
        gen = torch.where(active, gen + 1, gen)
    return SearchOut(best_ind, -best_fit, conv, gen, hist)


class CutSearcher:
    """Staged GA cut search for one fixed device population, on
    ``device``.

    Build once (host table construction), then each ``run(gen)`` is a
    search on the device with no host synchronisation, cheap enough to
    call every federation round. The trainer caches one searcher per
    (devices, server, batch, config) and builds a new one only on churn
    or a profile change.
    """

    def __init__(self, devices: Sequence[DeviceProfile],
                 server: DeviceProfile = PAPER_SERVER, *,
                 batch: int = 64, config: GAConfig = None,
                 options: Optional[List[Cut]] = None, device="cuda"):
        self.config = config = config or GAConfig()
        self.device = resolve_device(device)
        self.options = all_cut_options() if options is None else options
        self.n_clients = len(devices)
        profile_of, n_genes = _profile_reduction(devices,
                                                 config.profile_based)
        self.profile_of = profile_of
        self.n_genes = n_genes
        if profile_of is not None:
            # appendix D taken all the way: fitness itself collapses to
            # the unique profiles. Tables carry one row per profile and
            # a client-count vector; identical clients share a gene, so
            # their barrier and completion terms coincide (max is
            # idempotent) and only n_active needs the multiplicity.
            reps = [None] * n_genes
            for k, d in enumerate(devices):
                r = reps[profile_of[k]]
                if r is None:
                    reps[profile_of[k]] = d
                elif r != d:
                    # the collapsed evaluation would score a population
                    # that does not exist
                    raise ValueError(
                        f"devices sharing profile name {d.name!r} have "
                        f"different specs ({r} vs {d}); rename the "
                        "profile or set profile_based=False")
            self.counts = torch.as_tensor(
                np.bincount(profile_of, minlength=n_genes).astype(
                    np.float32), device=self.device)
            table_devices = reps
        else:
            self.counts = None
            table_devices = list(devices)
        self.tables = build_latency_tables(table_devices, server, batch,
                                           self.options, device=self.device)
        self._devices = list(devices)
        self._server = server
        self._batch = batch

    def run(self, gen: torch.Generator, *,
            init_pop: Optional[torch.Tensor] = None,
            draws: Optional[Callable[[int], Draws]] = None) -> SearchOut:
        """One full GA search drawing from ``gen`` (a generator on the
        searcher's device). ``init_pop`` and ``draws`` replace the
        draws from ``gen`` (the tests feed the reference's)."""
        cfg, n_opt = self.config, len(self.options)
        if init_pop is None:
            init_pop = draw_initial(gen, cfg, self.n_genes, n_opt)
        if draws is None:
            def draws(_):
                return draw_generation(gen, cfg, self.n_genes, n_opt)
        return search(self.tables, self.counts, cfg, init_pop, draws)

    def to_result(self, out: SearchOut) -> GAResult:
        """Read back a SearchOut and re-evaluate the winning cuts through
        the host float64 model, so the reported latency compares exactly
        with the numpy oracle's."""
        best_ind = out.best_ind.cpu().numpy()
        gens_run = int(out.generations_run)
        conv = int(out.convergence_gen)
        history = [float(h) for h in
                   out.history.cpu().numpy()[: gens_run + 1]]
        cuts = _upsample_cuts(best_ind, self.profile_of, self.n_clients,
                              self.options)
        latency = huscf_iteration_latency(cuts, self._devices,
                                          self._server, self._batch)
        # convention check: the converging generation's recorded best is
        # the final best (float32 tables, so a relative tolerance)
        if not np.isclose(history[conv], float(out.best_latency),
                          rtol=1e-6):
            raise RuntimeError(f"GA bookkeeping: history[{conv}] = "
                               f"{history[conv]} is not the final best "
                               f"{float(out.best_latency)}")
        return GAResult(cuts=cuts, latency=float(latency),
                        generations_run=gens_run, convergence_gen=conv,
                        history=history)


# ---------------------------------------------------------------------------
# host numpy oracle
# ---------------------------------------------------------------------------

def _fitness_factory(devices: Sequence[DeviceProfile],
                     server: DeviceProfile, batch: int,
                     profile_of: Optional[np.ndarray],
                     options: List[Cut]) -> Callable[[np.ndarray], float]:
    def fitness(ind: np.ndarray) -> float:
        cuts = _upsample_cuts(ind, profile_of, len(devices), options)
        return -huscf_iteration_latency(cuts, devices, server, batch)
    return fitness


def _optimize_cuts_host(devices: Sequence[DeviceProfile],
                        server: DeviceProfile, batch: int,
                        config: GAConfig) -> GAResult:
    options = all_cut_options()
    n_opt = len(options)
    rng = np.random.default_rng(config.seed)
    profile_of, n_genes = _profile_reduction(devices, config.profile_based)
    fitness = _fitness_factory(devices, server, batch, profile_of, options)

    pop = rng.integers(0, n_opt, size=(config.population_size, n_genes))
    fits = np.array([fitness(ind) for ind in pop])
    best_fit = float(fits.max())
    best_ind = pop[int(np.argmax(fits))].copy()
    history: List[float] = [-best_fit]
    convergence_gen = 0
    stall = 0
    gen = 0

    # memoize fitness: the gene space is small under profile reduction
    cache: dict = {}

    def cached_fitness(ind: np.ndarray) -> float:
        key = ind.tobytes()
        if key not in cache:
            cache[key] = fitness(ind)
        return cache[key]

    for gen in range(1, config.generations + 1):
        order = np.argsort(-fits)
        elite = pop[order[: config.elitism]].copy()
        children = []
        while len(children) < config.population_size - config.elitism:
            def tournament():
                idx = rng.integers(0, config.population_size,
                                   config.tournament_size)
                return pop[idx[np.argmax(fits[idx])]]

            p1, p2 = tournament().copy(), tournament().copy()
            if rng.random() < config.crossover_rate and n_genes > 1:
                if rng.random() < 0.5:  # uniform
                    mask = rng.random(n_genes) < 0.5
                    p1[mask], p2[mask] = p2[mask].copy(), p1[mask].copy()
                else:  # two-point
                    a, b_ = sorted(rng.integers(0, n_genes, 2))
                    p1[a:b_ + 1], p2[a:b_ + 1] = (p2[a:b_ + 1].copy(),
                                                  p1[a:b_ + 1].copy())
            for child in (p1, p2):
                mut = rng.random(n_genes) < config.mutation_rate
                child[mut] = rng.integers(0, n_opt, int(mut.sum()))
                children.append(child)
        pop = np.vstack([elite, np.array(children[: config.population_size
                                                  - config.elitism])])
        fits = np.array([cached_fitness(ind) for ind in pop])

        gen_best = float(fits.max())
        history.append(-gen_best)
        if gen_best > best_fit + 1e-12:
            best_fit = gen_best
            best_ind = pop[int(np.argmax(fits))].copy()
            convergence_gen = gen
            stall = 0
        else:
            stall += 1
            if stall >= config.early_stop_patience:
                break

    if history[convergence_gen] != -best_fit:
        raise RuntimeError("GA bookkeeping: history[convergence_gen] is "
                           "not the final best")
    cuts = _upsample_cuts(best_ind, profile_of, len(devices), options)
    return GAResult(cuts=cuts, latency=-best_fit, generations_run=gen,
                    convergence_gen=convergence_gen, history=history)


def optimize_cuts(devices: Sequence[DeviceProfile],
                  server: DeviceProfile = PAPER_SERVER, *,
                  batch: int = 64, config: GAConfig = None,
                  fused: Optional[bool] = None, device="cuda") -> GAResult:
    """GA cut search. ``config.fused`` (overridable through ``fused``)
    runs the search on ``device`` from a generator seeded
    ``config.seed``; the numpy oracle runs the same operators one scalar
    fitness call at a time on the host."""
    config = config or GAConfig()
    if fused is not None:
        config = dataclasses.replace(config, fused=fused)
    if config.fused:
        searcher = CutSearcher(devices, server, batch=batch, config=config,
                               device=device)
        gen = torch.Generator(device=searcher.device).manual_seed(
            config.seed)
        return searcher.to_result(searcher.run(gen))
    return _optimize_cuts_host(devices, server, batch, config)


def exhaustive_profile_optimum(devices: Sequence[DeviceProfile],
                               server: DeviceProfile = PAPER_SERVER,
                               batch: int = 64) -> Tuple[List[Cut], float]:
    """Coordinate descent over profiles on the host in float64: a sanity
    bound for small populations, not the exact optimum (barriers couple
    profiles). The full assignment is re-evaluated after every profile
    update and the (cuts, latency) snapshot is taken from that same
    evaluation, so the returned latency is the latency of the returned
    cuts."""
    options = all_cut_options()
    names = [d.name for d in devices]
    uniq = sorted(set(names))
    best_global = None
    best_cuts = None
    # coordinate descent from a sensible start
    assign = {nm: options[0] for nm in uniq}
    for _ in range(4):
        for nm in uniq:
            best_local = None
            for opt in options:
                trial = dict(assign)
                trial[nm] = opt
                cuts = [trial[n_] for n_ in names]
                lat = huscf_iteration_latency(cuts, devices, server, batch)
                if best_local is None or lat < best_local[0]:
                    best_local = (lat, opt)
            assign[nm] = best_local[1]
            cuts_now = [assign[n_] for n_ in names]
            lat_now = huscf_iteration_latency(cuts_now, devices, server,
                                              batch)
            if best_global is None or lat_now < best_global:
                best_global = lat_now
                best_cuts = cuts_now
    return best_cuts, best_global
