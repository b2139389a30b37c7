"""Genetic algorithm for cut-point selection — paper §4.3 + App. D (port
of the host numpy path of ``repro.core.genetic``).

Minimizes ``huscf_iteration_latency`` over the joint per-client cut
vector with the paper's operators: tournament selection (size 5),
uniform and two-point crossover alternated 50/50 with probability
``crossover_rate``, per-gene mutation, elitism, and the appendix-D
profile reduction (one gene per device profile). It draws from
``np.random.default_rng(seed)`` exactly as the reference's host path
does, so the same config returns the same ``GAResult``.

The device-resident fused search of the reference is not ported yet
(ROADMAP M9); ``fused=True`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.latency import (Cut, DeviceProfile, PAPER_SERVER,
                                      all_cut_options,
                                      huscf_iteration_latency)


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
    fused: bool = False          # the device-resident GA is ROADMAP M9


@dataclasses.dataclass
class GAResult:
    cuts: List[Cut]            # per client
    latency: float
    generations_run: int
    convergence_gen: int       # generation that first held the final best
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
                  fused: Optional[bool] = None) -> GAResult:
    """GA cut search on the host. ``fused=True`` (the reference's
    device-resident search) is not ported yet."""
    config = config or GAConfig()
    if fused is not None:
        config = dataclasses.replace(config, fused=fused)
    if config.fused:
        raise NotImplementedError("the fused device-resident GA is not "
                                  "ported yet (ROADMAP M9); use fused=False")
    return _optimize_cuts_host(devices, server, batch, config)
