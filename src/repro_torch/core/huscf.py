"""HuSCF-GAN trainer — the paper's five-stage procedure (§4.1), in
PyTorch (port of ``repro.core.huscf``).

1. GA cut selection from device capabilities (``core.genetic``'s search
   on the trainer's device).
2. Heterogeneous U-shaped split training of G and D (``core.segments``).
3. Every E epochs: k-means on the discriminator's middle-activation EMA.
4. Log-space KLD weights, then the clustered Eq.-16 aggregation of the
   client segments; vanilla FedAvg for the first warm-up rounds.

Stage 2 runs as fused epochs by default (``make_epoch_fn``, the
reference's ``fused_epoch``): every step writes into the trainer's own
tensors and draws its batch on the device, and on the card an epoch is
replays of a CUDA graph of the step; ``fused_epoch=False`` runs the
per-step loop, the oracle. Both nets run the executor of the compiled
``SplitProgram`` (``build_net_apply``); ``split_program=False`` runs
the reference's legacy per-group loops (``build_net_apply_legacy``),
which issue the same layer calls and agree with it bit for bit.

Stages 3 and 4 run on the device; with ``use_kernel`` (the default
here) the assignment step of k-means is kernel K2 and every
aggregation (every chunk tile of a chunk-streamed round) is kernel K1.
``fused_cluster=False`` and ``federate(use_label_kld=True)`` (the
FeGAN-style label-histogram KLD, paper §6.3) run the reference's host
numpy clustering and weights instead; the aggregation stays on the
device.

Population scale: ``cohort_size`` samples that many of the registered
clients (``core.registry``) per round from the trainer's own cohort
generator, and ``agg_chunk`` streams every aggregation in client chunks
instead of the dense ``[K, D]`` buffer.

Online re-cut and churn: ``reoptimize_every`` re-runs the GA search on
the device every that many rounds and regroups only on strictly better
cuts; ``apply_churn`` (clients leave and join) and ``update_profile`` (a
client reports new capabilities) re-derive the cuts for the changed
population. Each regroup migrates the client and server parameters and
the middle-activation EMA to the new groups, restarts Adam's moments,
re-stages the dataset and empties the federation plan cache.

``generate`` runs the generator's split program in eval mode.

Not ported yet, raising ``NotImplementedError`` that names its ROADMAP
item: mesh-sharded federation (M10).
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kld as kld_mod
from repro_torch.core.clustering import (cluster_activations,
                                         cluster_activations_np,
                                         k_selection_bound)
from repro_torch.core.federation import (N_LAYERS, federate_client_params,
                                         federate_client_params_device,
                                         fedavg_uniform)
from repro_torch.core.genetic import CutSearcher, GAConfig, optimize_cuts
from repro_torch.core.latency import (Cut, DeviceProfile, PAPER_DEVICES,
                                      PAPER_SERVER, huscf_iteration_latency)
from repro_torch.core.registry import ClientRegistry
from repro_torch.core.segments import (NET_LAYER_DEFS, compile_split_program,
                                       head_pass, make_apply, server_pass,
                                       tail_pass)
from repro_torch.core.splitting import (ProfileGroup, client_owned_layers,
                                        group_by_profile, layer_pair,
                                        server_union_span)
from repro_torch.data.partition import ClientSpec
from repro_torch.data.pipeline import sample_batch, stage_clients
from repro_torch.models import gan
from repro_torch.models.gan import (DISC_LAYER_DEFS, DISC_MIDDLE_FEATURES,
                                    GEN_LAYER_DEFS, Z_DIM)
from repro_torch.optim.optimizers import AdamState, adam
from repro_torch.tree import tree_from_items, tree_items, tree_map

_EMA_DECAY = 0.8                     # middle-activation EMA (stage 3 input)


@dataclasses.dataclass
class HuSCFConfig:
    batch: int = 32
    federate_every: int = 5          # E
    beta: float = 150.0              # KLD weight scale
    lr: float = 2e-4
    adam_b1: float = 0.5
    num_clusters: Optional[int] = None   # None -> silhouette selection
    seed: int = 0
    use_kernel: bool = True          # kernels K1/K2 (the reference: False)
    steps_per_epoch: Optional[int] = None
    warmup_fed_rounds: int = 2       # vanilla FedAvg rounds (paper §4.5)
    fused_epoch: bool = True         # device-resident fused epochs (CUDA
    #                                  graphs on the card); False = the
    #                                  per-step loop (oracle)
    fused_cluster: bool = True       # False: host numpy stages 3+4
    epoch_unroll: Optional[int] = None   # steps per captured graph of a
    #                                  fused epoch; None = 1
    cohort_size: Optional[int] = None        # clients sampled per round
    agg_chunk: Optional[int] = None          # chunk-streamed aggregation
    reoptimize_every: Optional[int] = None   # re-cut every this many
    #                                  rounds (strictly better cuts only);
    #                                  None = static cuts (the paper)
    split_program: bool = True       # False: the legacy hand-rolled
    #                                  per-group loops
    #                                  (build_net_apply_legacy), the
    #                                  bit-exactness oracle


# ---------------------------------------------------------------------------
# functional forward passes over the split topology
# ---------------------------------------------------------------------------

def build_net_apply(groups: Sequence[ProfileGroup], net: str,
                    capture_middle: bool = False,
                    concat_groups: bool = True) -> Callable:
    """Returns ``apply(client_params, server_params, inputs, train) ->
    (outputs {gname: [K, b, ...]}, new_client, new_server, middles)``
    with ``inputs`` = {gname: tuple of per-client-stacked tensors fed to
    layer 0}: the executor of the compiled ``SplitProgram``
    (``core.segments.make_apply``)."""
    return make_apply(compile_split_program(groups, net),
                      capture_middle=capture_middle,
                      concat_groups=concat_groups)


def build_net_apply_legacy(groups: Sequence[ProfileGroup], net: str,
                           capture_middle: bool = False,
                           concat_groups: bool = True) -> Callable:
    """``build_net_apply``'s contract without a ``SplitProgram``: the
    reference's legacy hand-rolled per-group loops, which derive each
    server layer's active groups and each group's departure inline from
    the cuts. They issue the program executor's layer calls in the same
    order, so the two agree bit for bit; this one is the oracle behind
    ``HuSCFConfig.split_program=False``. ``concat_groups=False`` is the
    no-concat server schedule (per-group BatchNorm statistics,
    ``core.segments``)."""
    defs = NET_LAYER_DEFS[net]
    n = len(defs)
    middle = n // 2
    span = server_union_span(groups, net, n)

    def apply(client_params, server_params, inputs, train: bool):
        new_client = {g.name: dict(client_params[g.name]) for g in groups}
        new_server = dict(server_params)
        bufs: Dict[str, torch.Tensor] = {}
        shapes: Dict[str, Tuple[int, int]] = {}
        for g in groups:
            h, _ = layer_pair(g.cut, net)
            acts, upd = head_pass(defs, client_params[g.name],
                                  inputs[g.name], h, train)
            new_client[g.name].update(upd)
            k, b = acts.shape[0], acts.shape[1]
            shapes[g.name] = (k, b)
            bufs[g.name] = acts.reshape((k * b,) + acts.shape[2:])
        outs: Dict[str, torch.Tensor] = {}
        middles: Dict[str, torch.Tensor] = {}
        for l in span:
            active = [g for g in groups
                      if layer_pair(g.cut, net)[0] <= l
                      < layer_pair(g.cut, net)[1]]
            parts, new_server[str(l)] = server_pass(
                defs[l], server_params[str(l)],
                [bufs[g.name] for g in active], train, concat_groups)
            for g, part in zip(active, parts):
                bufs[g.name] = part
                if capture_middle and l == middle:
                    k, b = shapes[g.name]
                    middles[g.name] = part.reshape(k, b, -1).float().mean(1)
                if layer_pair(g.cut, net)[1] == l + 1:
                    outs[g.name] = part
        results: Dict[str, torch.Tensor] = {}
        for g in groups:
            _, t = layer_pair(g.cut, net)
            k, b = shapes[g.name]
            x = outs[g.name]
            y, upd = tail_pass(defs, client_params[g.name],
                               x.reshape((k, b) + x.shape[1:]), t, n, train)
            new_client[g.name].update(upd)
            results[g.name] = y
        return results, new_client, new_server, middles

    return apply


def _fits(buf: torch.Tensor, x) -> bool:
    """``x`` can be copied into the carry tensor ``buf``: a tensor of the
    same shape, dtype and device, or an int for a 0-dim integer one."""
    if not isinstance(x, torch.Tensor):
        return isinstance(x, (int, np.integer)) and buf.dim() == 0 and \
            not buf.is_floating_point()
    return (x.shape == buf.shape and x.dtype == buf.dtype
            and x.device == buf.device)


def _host(mask: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    return None if mask is None else mask.cpu().numpy()


def merge_bn(updated: Dict, bn: Dict) -> Dict:
    """Optimizer-updated learnables, but BatchNorm running statistics
    (keys 'mean'/'var') from the forward pass."""
    if isinstance(updated, dict):
        return {k: (bn.get(k, v) if k in ("mean", "var") and
                    not isinstance(v, dict) else merge_bn(v, bn.get(k, {})))
                for k, v in updated.items()}
    return updated


def merge_bn_(params: Dict, bn: Dict) -> None:
    """``merge_bn`` in place: the forward pass's BatchNorm running
    statistics are copied into ``params``' own tensors."""
    for k, v in params.items():
        if isinstance(v, dict):
            merge_bn_(v, bn.get(k, {}))
        elif k in ("mean", "var") and k in bn:
            v.copy_(bn[k])


def _is_stat(path) -> bool:
    return path[-1] in ("mean", "var")


def value_and_grad(loss_fn: Callable, params: Dict):
    """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)`` with
    respect to every learnable leaf; BatchNorm statistics get zero
    gradients, as they do under ``jax.grad``."""
    items = list(tree_items(params))
    learn = {p: x.detach().requires_grad_(True)
             for p, x in items if not _is_stat(p)}
    loss, aux = loss_fn(tree_from_items(
        (p, learn.get(p, x)) for p, x in items))
    gmap = dict(zip(learn, torch.autograd.grad(loss, list(learn.values()))))
    grads = tree_from_items(
        (p, gmap[p] if p in gmap else torch.zeros_like(x)) for p, x in items)
    return loss.detach(), aux, grads


# ---------------------------------------------------------------------------
# the fused epoch
# ---------------------------------------------------------------------------

def _carry_items(state: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf a fused step writes: both nets'
    parameters and BatchNorm statistics, and each Adam state's step and
    moments. ``state["step"]`` is a host counter and not among them."""
    items = []
    for net in ("G", "D"):
        items += [((net,) + p, x) for p, x in tree_items(state[net])]
    for opt in ("opt_g", "opt_d"):
        st = state[opt]
        items.append(((opt, "step"), st.step))
        for field in ("mu", "nu"):
            items += [((opt, field) + p, x)
                      for p, x in tree_items(getattr(st, field))]
    return items


def _state_from_carry(items, step: int) -> Dict[str, Any]:
    """Inverse of ``_carry_items``, with the host step counter."""
    t = tree_from_items(items)
    return {"G": t["G"], "D": t["D"], "step": step,
            **{opt: AdamState(t[opt]["step"], t[opt]["mu"], t[opt]["nu"])
               for opt in ("opt_g", "opt_d")}}


# one side stream per device for every trainer's warm-ups and captures:
# cuBLAS keeps a workspace per (handle, stream) for the life of the
# process, so a stream per trainer would leave one behind for each,
# pinning whatever segment of device memory it landed in
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


class GraphPool:
    """What the fused epochs of one trainer share on the card: the side
    stream they warm up and capture on, the private memory pool of their
    CUDA graphs, whether the eager warm-up step has run since the graphs
    were last dropped, and the capture seconds and pool bytes so far
    (the device memory the captures reserved)."""

    def __init__(self, device: torch.device):
        index = torch.device(device).index or 0
        if index not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
        self.stream = _CAPTURE_STREAMS[index]
        self.clear()

    def clear(self) -> None:
        """Forget the pool and the warm-up; the graphs themselves belong
        to the epoch functions, which the trainer drops beside."""
        self.pool = None
        self.warm = False
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.graphs = 0

    def warm_up(self, step: Callable[[], None]) -> None:
        """One eager step on the capture stream: a real step, and the
        warm-up that initialises what cuDNN, cuBLAS and autograd create
        lazily before a capture may run them."""
        s, cur = self.stream, torch.cuda.current_stream(self.stream.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            step()
        cur.wait_stream(s)
        self.warm = True

    def capture(self, run: Callable[[], None],
                gen: torch.Generator) -> "torch.cuda.CUDAGraph":
        """``run`` captured as a CUDA graph in the shared pool, with
        ``gen`` registered so that each replay advances it as running
        ``run`` eagerly would. A capture that fails raises."""
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(gen)
        dev = self.stream.device
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(g, pool=self.pool, stream=self.stream):
            run()
        torch.cuda.synchronize(dev)
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(dev) - before
        self.graphs += 1
        if self.pool is None:
            self.pool = g.pool()
        return g

    @staticmethod
    def replay(graphs: Sequence[Any]) -> None:
        """Replay ``graphs`` in order, with every host synchronisation an
        error (torch's sync debug mode) while they are launched."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for g in graphs:
                g.replay()
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def make_epoch_fn(groups: Sequence[ProfileGroup], step_core: Callable,
                  sample: Callable, n_steps: int, unroll: int = 1,
                  graphs: Optional[GraphPool] = None) -> Callable:
    """The fused epoch (the reference's ``make_epoch_fn``), shared by the
    trainer's card and CPU paths.

    ``step_core(state, batch) -> (metrics, mids)`` runs one training step
    in place on ``state``'s tensors, with ``mids`` the per-group ``[K_p,
    F]`` middle-activation batch means; ``sample(gen) -> batch``. Returns
    ``epoch(state, gen, ema, ema_init, losses) -> losses`` over the carry
    ``(state, gen, mid_ema [K, F], ema_init)``: each of the ``n_steps``
    steps draws a batch from ``gen``, runs ``step_core``, writes each
    group's EMA rows (the first observation copies, later ones blend,
    under the 0-dim device bool ``ema_init``, which it then sets) and
    copies its metrics into the 0-dim tensors of ``losses``. Nothing is
    read back.

    Without ``graphs`` the steps run eagerly one after another: the plain
    version of the graph (the CPU path). With a ``GraphPool`` (the card)
    the first step after the pool was cleared runs eagerly as its
    warm-up; the rest run as replays of CUDA graphs of ``unroll`` steps
    each, a remainder in a graph of its own, each captured on its first
    use. A graph reads and writes the tensors it was captured on, so
    every later call must pass the same carry: another raises.
    """
    unroll = max(1, min(n_steps, unroll))
    rows: Dict[str, torch.Tensor] = {}
    captured: Dict[int, Any] = {}
    carry_ref: List[Any] = []

    def body(state, gen, ema, ema_init, losses):
        metrics, mids = step_core(state, sample(gen))
        for g in groups:
            m = mids[g.name].detach().float()
            prev = ema.index_select(0, rows[g.name])
            ema.index_copy_(0, rows[g.name], torch.where(
                ema_init, _EMA_DECAY * prev + (1 - _EMA_DECAY) * m, m))
        ema_init.fill_(True)
        for k, v in metrics.items():
            losses[k].copy_(v)

    def epoch(state, gen, ema, ema_init, losses):
        if not rows:
            rows.update({g.name: torch.as_tensor(g.client_ids,
                                                 device=ema.device)
                         for g in groups})
        args = (state, gen, ema, ema_init, losses)
        if graphs is None:
            for _ in range(n_steps):
                body(*args)
            return losses
        carry = [x for _, x in _carry_items(state)] + [ema, ema_init, gen,
                                                        *losses.values()]
        if carry_ref and (len(carry) != len(carry_ref) or any(
                a is not b for a, b in zip(carry, carry_ref))):
            raise RuntimeError("a fused epoch's CUDA graphs were captured "
                               "on other tensors than this carry")
        left = n_steps
        if not graphs.warm:
            graphs.warm_up(lambda: body(*args))
            left -= 1
        sizes = [unroll] * (left // unroll) + (
            [left % unroll] if left % unroll else [])
        for k in sizes:
            if k not in captured:
                carry_ref[:] = carry
                # the graph keeps the tensors it was captured on; so does
                # its function, on its own copy of the state's dicts,
                # which a caller may re-point later (federate assigns
                # new client trees into them)
                own = (_state_from_carry(_carry_items(state), state["step"]),
                       *args[1:])
                captured[k] = graphs.capture(
                    lambda k=k, own=own: [body(*own) for _ in range(k)], gen)
        graphs.replay([captured[k] for k in sizes])
        return losses

    return epoch


class HuSCFTrainer:
    """End-to-end HuSCF-GAN over a client population.

    ``batch_source``: optional callable returning the next training
    batch ({"real_img", "real_y", "z", "fake_y"} -> {gname: tensor});
    without it batches are drawn on the device from the staged dataset.
    A host callable cannot be replayed, so on the card it needs
    ``fused_epoch=False``.

    Fused epochs (``cfg.fused_epoch``, the default) run ``make_epoch_fn``
    over the trainer's carry: the state's tensors, the middle-activation
    EMA, a device flag for the EMA's first observation and the training
    generator. Every step writes into the same tensors; before each
    epoch a leaf replaced from outside (a federation round, a checkpoint
    load, an assignment) is copied into its tensor, and a regroup drops
    the captured graphs. On the card an epoch is replays of CUDA graphs
    of ``cfg.epoch_unroll`` steps (default 1) after one eager warm-up
    step; on the CPU the same steps run eagerly. The losses are read
    back once per epoch. ``cfg.fused_epoch=False`` runs the per-step
    loop, the oracle.
    """

    def __init__(self, clients: Sequence[ClientSpec],
                 devices: Optional[Sequence[DeviceProfile]] = None,
                 cuts: Optional[Sequence[Cut]] = None,
                 config: HuSCFConfig = HuSCFConfig(),
                 server: DeviceProfile = PAPER_SERVER,
                 ga_config: Optional[GAConfig] = None,
                 device="cuda",
                 batch_source: Optional[Callable[[], Dict]] = None,
                 fed_mesh: Any = None):
        if fed_mesh is not None:
            raise NotImplementedError("mesh-sharded federation is not "
                                      "ported (ROADMAP M10, mesh code)")
        self.device = resolve_device(device)
        self.clients = list(clients)
        self.cfg = config
        K = len(self.clients)
        if config.cohort_size is not None and not (
                1 <= config.cohort_size <= K):
            raise ValueError(f"cohort_size {config.cohort_size} out of "
                             f"range for {K} registered clients")
        if devices is None:
            devices = [PAPER_DEVICES[i % len(PAPER_DEVICES)] for i in range(K)]
        self.devices = list(devices)
        self.server_profile = server

        # Stage 1: GA cut selection, on the trainer's device
        self._ga_config = ga_config or GAConfig(population_size=200,
                                                generations=30,
                                                seed=config.seed)
        self.ga_seconds: Optional[float] = None    # wall time of the GA
        if cuts is None:
            t0 = time.perf_counter()
            result = optimize_cuts(self.devices, server, batch=config.batch,
                                   config=self._ga_config,
                                   device=self.device)
            self.ga_seconds = time.perf_counter() - t0
            cuts = result.cuts
            self.ga_latency = result.latency
        else:
            self.ga_latency = huscf_iteration_latency(cuts, self.devices,
                                                      server, config.batch)
        self.cuts = list(cuts)
        self.groups = group_by_profile(self.devices, self.cuts)
        self.sizes = np.array([c.n for c in self.clients], np.int64)

        self._opt_init, self._opt_update = adam(config.lr, b1=config.adam_b1)
        self._epoch_fns: Dict[int, Callable] = {}
        self._graph_pool = (GraphPool(self.device)
                            if self.device.type == "cuda" else None)
        self.state = self._init_state(
            torch.Generator().manual_seed(config.seed))
        self._dataset = stage_clients(self.groups, self.clients, self.device)
        self._batch_source = batch_source
        # generate()'s latent draws: numpy, seeded as in the reference, so
        # one state gives the reference's images
        self._rng = np.random.default_rng(config.seed + 1)
        self._train_gen = self._generator(config.seed + 1)
        self._cluster_gen = self._generator(config.seed + 2)
        # the registered population; cohorts draw from their own
        # generator so that enabling them never shifts the cluster stream
        self.registry = ClientRegistry.from_clients(self.clients)
        self._cohort_gen = self._generator(config.seed + 3)
        # online re-cut: the GA's own generator, and one staged searcher
        # per device population (a new one only on churn or a profile
        # change)
        self._ga_gen = self._generator(config.seed + 4)
        self._searchers: Dict = {}
        self._mid_ema = torch.zeros((K, DISC_MIDDLE_FEATURES),
                                    dtype=torch.float32, device=self.device)
        self._ema_init = False           # host mirror of the device flag
        # the fused epoch's own carry: the EMA's device flag, the last
        # step's losses, and the fixed tensors its steps write into
        self._ema_flag = torch.zeros((), dtype=torch.bool, device=self.device)
        self._losses = {k: torch.zeros((), device=self.device)
                        for k in ("loss_d", "loss_g")}
        self._carry: Optional[List] = None
        self._carry_inputs: Tuple = ()
        self._sizes_dev = torch.as_tensor(self.sizes, dtype=torch.float32,
                                          device=self.device)
        self._rows = {g.name: torch.as_tensor(g.client_ids, device=self.device)
                      for g in self.groups}
        self._fed_plans: Dict = {}
        self._build_applies()
        self.fed_round = 0
        self.epoch = 0
        self.history: List[Dict[str, float]] = []
        self.fed_log: List[Dict[str, Any]] = []

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- initialization ----------------------------------------------------
    def _init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        dev = self.device
        params = {}
        for net, defs in (("G", GEN_LAYER_DEFS), ("D", DISC_LAYER_DEFS)):
            n = len(defs)
            server = {str(l): tree_map(lambda t: t[0],
                                       defs[l].init(1, gen, dev))
                      for l in server_union_span(self.groups, net, n)}
            client = {}
            for g in self.groups:
                h, t = ((g.cut.g_h, g.cut.g_t) if net == "G"
                        else (g.cut.d_h, g.cut.d_t))
                client[g.name] = {str(l): defs[l].init(g.size, gen, dev)
                                  for l in list(range(h)) + list(range(t, n))}
            params[net] = {"client": client, "server": server}
        return {"G": params["G"], "D": params["D"],
                "opt_g": self._init_opt(params["G"]),
                "opt_d": self._init_opt(params["D"]), "step": 0}

    def _init_opt(self, params) -> AdamState:
        """Adam's state with its step on the device, so that the bias
        corrections need no host value."""
        return self._opt_init(params)._replace(
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    # -- one training step ----------------------------------------------------
    def _mean_client_loss(self, logits: Dict[str, torch.Tensor],
                          target: float) -> torch.Tensor:
        total = sum(g.size for g in self.groups)
        tot = 0.0
        for g in self.groups:
            tot = tot + gan.bce_logits(logits[g.name].reshape(-1),
                                       target) * g.size
        return tot / total

    def _step(self, st: Dict[str, Any], batch: Dict[str, Dict[str, Any]],
              inplace: bool = False):
        """One D then G update from ``st`` on ``batch``: returns (the new
        state, the losses, the middle activations). ``inplace`` writes
        the new parameters, statistics, moments and steps into ``st``'s
        own tensors, one leaf at a time, and returns ``st``."""
        groups = self.groups
        g_params, d_params = st["G"], st["D"]
        gen_in = {g.name: (batch["z"][g.name], batch["fake_y"][g.name])
                  for g in groups}

        # ---------------- discriminator update (G detached)
        with torch.no_grad():
            fake, _, _, _ = self._gen_apply(g_params["client"],
                                            g_params["server"], gen_in, True)

        def d_loss(d_p):
            lr_, ncr, nsr, mids = self._disc_apply(
                d_p["client"], d_p["server"],
                {g.name: (batch["real_img"][g.name], batch["real_y"][g.name])
                 for g in groups}, True)
            lf_, _, _, _ = self._disc_apply(
                d_p["client"], d_p["server"],
                {g.name: (fake[g.name], batch["fake_y"][g.name])
                 for g in groups}, True)
            loss = (self._mean_client_loss(lr_, 1.0)
                    + self._mean_client_loss(lf_, 0.0))
            return loss, ({"client": ncr, "server": nsr}, mids)

        loss_d, (d_bn, mids), grads_d = value_and_grad(d_loss, d_params)
        opt_d, d_new = self._opt_update(st["opt_d"], grads_d, d_params,
                                        inplace=inplace)
        del grads_d
        # keep BatchNorm running stats from the real-data pass
        if inplace:
            merge_bn_(d_new, d_bn)
        else:
            d_new = merge_bn(d_new, d_bn)

        # ---------------- generator update (vs updated D)
        def g_loss(g_p):
            fake, ncg, nsg, _ = self._gen_apply(g_p["client"], g_p["server"],
                                                gen_in, True)
            logits, _, _, _ = self._disc_apply(
                d_new["client"], d_new["server"],
                {g.name: (fake[g.name], batch["fake_y"][g.name])
                 for g in groups}, True)
            return (self._mean_client_loss(logits, 1.0),
                    {"client": ncg, "server": nsg})

        loss_g, g_bn, grads_g = value_and_grad(g_loss, g_params)
        opt_g, g_new = self._opt_update(st["opt_g"], grads_g, g_params,
                                        inplace=inplace)
        del grads_g
        metrics = {"loss_d": loss_d, "loss_g": loss_g}
        if inplace:
            merge_bn_(g_new, g_bn)
            return st, metrics, mids
        g_new = merge_bn(g_new, g_bn)
        return ({"G": g_new, "D": d_new, "opt_g": opt_g, "opt_d": opt_d,
                 "step": st["step"] + 1}, metrics, mids)

    def _sample(self, gen: torch.Generator):
        """One training batch: the ``batch_source``'s next, else drawn on
        the device from the staged dataset with ``gen``."""
        if self._batch_source is not None:
            return self._batch_source()
        return sample_batch(self._dataset, gen, batch=self.cfg.batch,
                            z_dim=Z_DIM, num_classes=gan.NUM_CLASSES)

    # -- the fused epoch -----------------------------------------------------
    def _build_epoch(self, n_steps: int) -> Callable:
        # the epoch lives in self._epoch_fns, so it holds the trainer
        # weakly: a cycle would keep the state and the graphs' pool on
        # the card until the garbage collector found it
        me = weakref.proxy(self)
        return make_epoch_fn(
            self.groups, lambda st, b: me._step(st, b, inplace=True)[1:],
            lambda gen: me._sample(gen), n_steps,
            unroll=self.cfg.epoch_unroll or 1, graphs=self._graph_pool)

    def _drop_graphs(self) -> None:
        """Everything captured on the old carry or grouping goes: the
        epoch functions with their graphs, the pool and the warm-up (the
        reference's ``_epoch_fns.clear()``)."""
        self._epoch_fns.clear()
        self._carry = None
        if self._graph_pool is not None:
            self._graph_pool.clear()

    def _adopt_carry(self) -> None:
        """Make the trainer's own tensors the state's leaves and the EMA,
        the fixed tensors that fused steps write into. A leaf replaced
        since the last fused epoch with the same shape and dtype is
        copied into its tensor; a new structure, or new data, rows or
        generator, makes copies of the current leaves the carry and
        drops the graphs. Tensors a caller handed in are never written."""
        items = _carry_items(self.state) + [(("ema",), self._mid_ema)]
        inputs = (self._dataset, self._rows, self._train_gen)
        carry = self._carry
        if carry is None or len(carry) != len(items) or any(
                a is not b for a, b in zip(inputs, self._carry_inputs)) \
                or not all(p == q and _fits(buf, x)
                           for (p, buf), (q, x) in zip(carry, items)):
            self._drop_graphs()
            carry = [(p, torch.full((), x, dtype=torch.int32,
                                    device=self.device)
                      if not isinstance(x, torch.Tensor)
                      else x.clone(memory_format=torch.contiguous_format))
                     for p, x in items]
            self._carry, self._carry_inputs = carry, inputs
        else:
            for (_, buf), (_, x) in zip(carry, items):
                if x is not buf:
                    if isinstance(x, torch.Tensor):
                        buf.copy_(x)
                    else:
                        buf.fill_(x)
        self.state = _state_from_carry(carry[:-1], self.state["step"])
        self._mid_ema = carry[-1][1]

    def _fused_epoch(self, n_steps: int) -> Dict[str, torch.Tensor]:
        """One fused epoch of ``n_steps``, nothing read back: returns the
        last step's losses as 0-dim device tensors."""
        if self._graph_pool is not None and self._batch_source is not None:
            raise ValueError("a batch_source is a host callable and cannot "
                             "be replayed in a CUDA graph: pass "
                             "fused_epoch=False to train from it on the card")
        self._adopt_carry()
        fn = self._epoch_fns.get(n_steps)
        if fn is None:
            fn = self._epoch_fns[n_steps] = self._build_epoch(n_steps)
        self._ema_flag.fill_(self._ema_init)
        fn(self.state, self._train_gen, self._mid_ema, self._ema_flag,
           self._losses)
        self._ema_init = True
        self.state["step"] += n_steps
        return self._losses

    # -- public API ----------------------------------------------------------
    def train_steps(self, n_steps: int) -> Dict[str, float]:
        if self.cfg.fused_epoch:
            losses = self._fused_epoch(n_steps)
            # the epoch's one readback
            return dict(zip(losses, torch.stack(list(losses.values()))
                            .tolist()))
        metrics = {}
        for _ in range(n_steps):
            self.state, metrics, mids = self._step(
                self.state, self._sample(self._train_gen))
            # middle-activation EMA, one [K, F] row per global client
            for g in self.groups:
                m = mids[g.name].detach().float()
                rows = self._rows[g.name]
                self._mid_ema[rows] = (
                    _EMA_DECAY * self._mid_ema[rows] + (1 - _EMA_DECAY) * m
                    if self._ema_init else m)
            self._ema_init = True
        return {k: float(v) for k, v in metrics.items()}

    def train_epoch(self) -> Dict[str, float]:
        steps = self.cfg.steps_per_epoch or max(
            1, int(np.median(self.sizes)) // self.cfg.batch)
        metrics = self.train_steps(steps)
        self.epoch += 1
        if self.epoch % self.cfg.federate_every == 0:
            self.federate()
        self.history.append(metrics)
        return metrics

    def middle_activations(self) -> np.ndarray:
        if not self._ema_init:
            raise RuntimeError("middle_activations() before any training "
                               "step: the EMA is empty")
        return self._mid_ema.detach().cpu().clone().numpy()

    def federate(self, use_label_kld: bool = False,
                 init_centers: Optional[Dict[int, torch.Tensor]] = None,
                 cohort_ids: Optional[torch.Tensor] = None
                 ) -> Dict[str, Any]:
        """Stages 3+4; returns diagnostics.

        With ``cfg.cohort_size`` each round first samples its cohort from
        the registry; Eq. 15 weights renormalize over the cohort and
        non-members keep their params. ``cfg.agg_chunk`` streams every
        aggregation in client chunks. The clustered round runs on the
        device unless ``cfg.fused_cluster`` is False or
        ``use_label_kld`` is set, which take the host numpy path.

        Tests feed the reference's draws: ``init_centers`` maps each
        candidate k to the k-means++ centres of the device path, and
        ``cohort_ids`` replaces this round's cohort draw."""
        self.fed_round += 1
        recut = None
        if (self.cfg.reoptimize_every is not None
                and self.fed_round % self.cfg.reoptimize_every == 0):
            # one search on the device against the current profiles;
            # regroups (and empties the plan cache) only on strictly
            # better cuts
            recut = self.reoptimize_cuts()
        cohort_mask = None
        if self.cfg.cohort_size is not None:
            if cohort_ids is None:
                cohort_ids = self.registry.sample_cohort(
                    self._cohort_gen, self.cfg.cohort_size)
            else:
                cohort_ids = torch.as_tensor(cohort_ids, dtype=torch.int32,
                                             device=self.device)
            cohort_mask = self.registry.cohort_mask(cohort_ids)
        elif cohort_ids is not None:
            raise ValueError("cohort_ids given to a trainer without "
                             "cohort_size")
        if self.fed_round <= self.cfg.warmup_fed_rounds:
            self._federate_nets(fedavg_uniform, self.sizes,
                                cohort_mask=_host(cohort_mask))
            diag = {"round": self.fed_round, "mode": "fedavg"}
        elif self.cfg.fused_cluster and not use_label_kld:
            diag = self._federate_clustered(init_centers, cohort_mask)
        else:
            diag = self._federate_host(use_label_kld, _host(cohort_mask))
        if cohort_ids is not None:
            diag["cohort"] = cohort_ids
        if recut is not None:
            diag["recut"] = recut
        self.fed_log.append(diag)
        return diag

    def _federate_nets(self, federate_fn: Callable, *args, **kwargs) -> None:
        """One aggregation per net over the client params (``federate_fn``
        is one of ``core.federation``'s rounds); the results replace
        them."""
        for net in ("G", "D"):
            wrapped = {g.name: {net: self.state[net]["client"][g.name]}
                       for g in self.groups}
            out = federate_fn(self.groups, wrapped, *args,
                              n_layers={net: N_LAYERS[net]},
                              use_kernel=self.cfg.use_kernel,
                              plan_cache=self._fed_plans,
                              chunk_size=self.cfg.agg_chunk, **kwargs)
            self.state[net]["client"] = {g.name: out[g.name][net]
                                         for g in self.groups}

    def _federate_clustered(self, init_centers, cohort_mask
                            ) -> Dict[str, Any]:
        if not self._ema_init:
            raise RuntimeError("federate() before any training step: the "
                               "middle-activation EMA is empty")
        acts = self._mid_ema
        labels, k_sel, sil = cluster_activations(
            acts, k=self.cfg.num_clusters, use_kernel=self.cfg.use_kernel,
            gen=self._cluster_gen, init_centers=init_centers)
        bound = k_selection_bound(len(self.clients), self.cfg.num_clusters)
        weights, klds = kld_mod.activation_weights(
            acts, self._sizes_dev, labels, bound, self.cfg.beta,
            cohort_mask=cohort_mask)
        self._federate_nets(federate_client_params_device, weights, labels,
                            bound, cohort_mask=cohort_mask,
                            cohort_size=self.cfg.cohort_size)
        return {"round": self.fed_round, "mode": "clustered", "k": k_sel,
                "silhouette": sil, "labels": labels, "weights": weights,
                "klds": klds}

    def _federate_host(self, use_label_kld: bool,
                       cohort_mask: Optional[np.ndarray]) -> Dict[str, Any]:
        """The reference's host round: numpy k-means from ``cfg.seed``,
        activation (or label-histogram) KLD weights, the cohort's Eq.-15
        renormalization (KLDs stay full-cluster), then the aggregation
        on the device."""
        acts = self.middle_activations()
        cl = cluster_activations_np(acts, k=self.cfg.num_clusters,
                                    seed=self.cfg.seed)
        if use_label_kld:
            hists = np.stack([np.bincount(c.labels,
                                          minlength=gan.NUM_CLASSES)
                              for c in self.clients])
            weights, klds = kld_mod.label_weights(hists, self.sizes,
                                                  cl.labels, self.cfg.beta)
        else:
            weights, klds = kld_mod.activation_weights_np(
                acts, self.sizes, cl.labels, self.cfg.beta)
        if cohort_mask is not None:
            weights = kld_mod.cohort_federation_weights_np(
                klds, self.sizes, cl.labels, cohort_mask, self.cfg.beta)
        self._federate_nets(federate_client_params, weights, cl.labels,
                            cohort_mask=cohort_mask)
        return {"round": self.fed_round, "mode": "clustered", "k": cl.k,
                "silhouette": cl.silhouette, "labels": cl.labels,
                "weights": weights, "klds": klds}

    # -- online cut re-optimization and population churn -------------------
    def _get_searcher(self, devices: Optional[Sequence[DeviceProfile]] = None
                      ) -> CutSearcher:
        """The staged searcher for a device population (default: the
        current one), cached so that repeated searches against an
        unchanged population build nothing."""
        devices = self.devices if devices is None else list(devices)
        key = (tuple(devices), self.server_profile, self.cfg.batch,
               dataclasses.astuple(self._ga_config))
        s = self._searchers.get(key)
        if s is None:
            s = self._searchers[key] = CutSearcher(
                devices, self.server_profile, batch=self.cfg.batch,
                config=self._ga_config, device=self.device)
        return s

    def _run_search(self, searcher: CutSearcher):
        """One search on the device from the trainer's GA generator (each
        search advances it). Nothing in it reads back to the host; the
        readback happens in ``to_result``."""
        return searcher.run(self._ga_gen)

    def reoptimize_cuts(self) -> bool:
        """Re-run the GA against the current device population; when it
        finds strictly better cuts than the live ones, regroup online.
        Returns whether the cuts changed: a search that only ties or
        loses against the incumbent changes nothing."""
        searcher = self._get_searcher()
        result = searcher.to_result(self._run_search(searcher))
        current = huscf_iteration_latency(self.cuts, self.devices,
                                          self.server_profile,
                                          self.cfg.batch)
        if result.latency >= current * (1 - 1e-9):
            return False
        self.ga_latency = result.latency
        self._rebuild_population(self.clients, self.devices, result.cuts,
                                 old_of=list(range(len(self.clients))))
        return True

    def apply_churn(self, leave: Sequence[int] = (),
                    join: Sequence[Tuple[ClientSpec, DeviceProfile]] = ()
                    ) -> List[Cut]:
        """Registry churn: ``leave`` are global client ids exiting,
        ``join`` (ClientSpec, DeviceProfile) pairs entering. Membership
        changed, so the cuts are re-derived unconditionally and the
        population rebuilds: survivors keep their trained parameters and
        EMA rows under their new ids, joiners start from the server's
        copies (the population mean where the server has none). Returns
        the new per-client cuts."""
        join = list(join)
        _, old_of = self.registry.churn(leave, [spec.n for spec, _ in join])
        joiners = iter(join)
        new_clients, new_devices = [], []
        for o in old_of:
            if o >= 0:
                new_clients.append(self.clients[o])
                new_devices.append(self.devices[o])
            else:
                spec, dev = next(joiners)
                new_clients.append(spec)
                new_devices.append(dev)
        searcher = self._get_searcher(new_devices)
        result = searcher.to_result(self._run_search(searcher))
        self.ga_latency = result.latency
        self._rebuild_population(new_clients, new_devices, result.cuts,
                                 old_of)
        return list(self.cuts)

    def update_profile(self, cid: int, profile: DeviceProfile) -> List[Cut]:
        """A registered client reports new capabilities (bandwidth or
        frequency drift): re-derive the cuts for the updated population
        and regroup. The client keeps its dataset, parameters and EMA
        row."""
        if not 0 <= cid < len(self.clients):
            raise ValueError(f"unknown client id {cid}")
        new_devices = list(self.devices)
        new_devices[cid] = profile
        searcher = self._get_searcher(new_devices)
        result = searcher.to_result(self._run_search(searcher))
        self.ga_latency = result.latency
        self._rebuild_population(self.clients, new_devices, result.cuts,
                                 old_of=list(range(len(self.clients))))
        return list(self.cuts)

    def _index(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def _migrate_client_params(self, net: str,
                               new_groups: Sequence[ProfileGroup],
                               old_of: Sequence[int]) -> Dict[str, Any]:
        """Client parameters for a rebuild; ``old_of[new_cid]`` is the old
        global id (-1: a joiner). A layer the client already owned keeps
        its trained copy; a layer it newly owns takes the server's copy
        (the server held it while the client delegated it); joiners take
        the server's copies too, and the old population mean for a layer
        the old server never held (every old client owned it). Each
        group's rows are gathered with one ``index_select`` per old
        group and leaf."""
        n = N_LAYERS[net]
        old_server = self.state[net]["server"]
        old_client = self.state[net]["client"]
        old_owned = {g.name: set(client_owned_layers(layer_pair(g.cut, net),
                                                     n))
                     for g in self.groups}
        old_loc = {cid: (g.name, pos) for g in self.groups
                   for pos, cid in enumerate(g.client_ids)}
        mean_cache: Dict[int, Any] = {}

        def shared_copy(l: int):
            if str(l) in old_server:
                return old_server[str(l)]
            if l not in mean_cache:
                stacks = [old_client[g.name][str(l)] for g in self.groups
                          if l in old_owned[g.name]]
                mean_cache[l] = tree_map(
                    lambda *xs: torch.cat(xs, 0).mean(0), *stacks)
            return mean_cache[l]

        out = {}
        for g in new_groups:
            out[g.name] = {}
            for l in client_owned_layers(layer_pair(g.cut, net), n):
                # rows copied from each old group, and the rows that take
                # the shared (server or mean) copy
                own: Dict[str, Tuple[List[int], List[int]]] = {}
                shared = []
                for pos, cid in enumerate(g.client_ids):
                    o = old_of[cid]
                    if o >= 0 and l in old_owned[old_loc[o][0]]:
                        gname, row = old_loc[o]
                        dst, src = own.setdefault(gname, ([], []))
                        dst.append(pos)
                        src.append(row)
                    else:
                        shared.append(pos)
                sources = [(self._index(dst), self._index(src),
                            dict(tree_items(old_client[gname][str(l)])))
                           for gname, (dst, src) in own.items()]
                base = dict(tree_items(shared_copy(l))) if shared else None
                shared_idx = self._index(shared)
                items = []
                for path, x in (base if base is not None
                                else sources[0][2]).items():
                    shape = x.shape if base is not None else x.shape[1:]
                    leaf = torch.empty((g.size,) + tuple(shape),
                                       dtype=x.dtype, device=x.device)
                    for dst, src, tree in sources:
                        leaf.index_copy_(0, dst, tree[path].index_select(0,
                                                                          src))
                    if base is not None:
                        leaf[shared_idx] = base[path]
                    items.append((path, leaf))
                out[g.name][str(l)] = tree_from_items(items)
        return out

    def _migrate_server_params(self, net: str,
                               new_groups: Sequence[ProfileGroup]
                               ) -> Dict[str, Any]:
        """The server span under the new cuts: layers the server already
        held keep their trained copies; a layer newly delegated to the
        server starts from the mean of the old client copies (every old
        client that hosted it owned it)."""
        n = N_LAYERS[net]
        old_server = self.state[net]["server"]
        old_client = self.state[net]["client"]
        new_server = {}
        for l in server_union_span(new_groups, net, n):
            if str(l) in old_server:
                new_server[str(l)] = old_server[str(l)]
                continue
            stacks = [old_client[g.name][str(l)] for g in self.groups
                      if l in client_owned_layers(layer_pair(g.cut, net), n)]
            new_server[str(l)] = tree_map(
                lambda *xs: torch.cat(xs, 0).mean(0), *stacks)
        return new_server

    def _rebuild_population(self, new_clients: Sequence[ClientSpec],
                            new_devices: Sequence[DeviceProfile],
                            new_cuts: Sequence[Cut],
                            old_of: Sequence[int]) -> None:
        """Swap in a new (clients, devices, cuts) population online:
        migrate parameters, optimizer and EMA, re-stage the dataset,
        rebuild the split programs and empty the federation plan cache
        (its keys hold the old groups)."""
        K_new = len(new_clients)
        if self.cfg.cohort_size is not None and not (
                1 <= self.cfg.cohort_size <= K_new):
            raise ValueError(
                f"cohort_size {self.cfg.cohort_size} out of range for "
                f"{K_new} registered clients after churn")
        new_groups = group_by_profile(new_devices, new_cuts)
        new_state: Dict[str, Any] = {}
        for net in ("G", "D"):
            new_state[net] = {
                "client": self._migrate_client_params(net, new_groups,
                                                      old_of),
                "server": self._migrate_server_params(net, new_groups)}
        # Adam's moments restart for the migrated structure; the step
        # counter survives
        new_state["opt_g"] = self._init_opt(new_state["G"])
        new_state["opt_d"] = self._init_opt(new_state["D"])
        new_state["step"] = self.state["step"]
        # the EMA is indexed by global client: survivors keep their rows
        # under the new ids, joiners start from the survivor mean once
        # the EMA holds activations
        new_ema = torch.zeros((K_new, self._mid_ema.shape[1]),
                              dtype=torch.float32, device=self.device)
        surv = [i for i, o in enumerate(old_of) if o >= 0]
        if surv:
            rows = self._mid_ema.index_select(
                0, self._index([old_of[i] for i in surv]))
            new_ema[self._index(surv)] = rows
            if self._ema_init and len(surv) < K_new:
                new_ema[self._index([i for i, o in enumerate(old_of)
                                     if o < 0])] = rows.mean(0)

        self.clients = list(new_clients)
        self.devices = list(new_devices)
        self.cuts = list(new_cuts)
        self.groups = new_groups
        self.sizes = np.array([c.n for c in self.clients], np.int64)
        self.registry = ClientRegistry.from_clients(self.clients)
        self._dataset = stage_clients(self.groups, self.clients, self.device)
        self.state = new_state
        self._mid_ema = new_ema
        self._sizes_dev = torch.as_tensor(self.sizes, dtype=torch.float32,
                                          device=self.device)
        self._rows = {g.name: self._index(g.client_ids) for g in self.groups}
        # everything keyed on the old grouping is stale
        self._fed_plans.clear()
        self._drop_graphs()
        self._build_applies()

    def _build_applies(self) -> None:
        """Both nets' executors for the current groups: the compiled
        program, or with ``cfg.split_program=False`` the legacy loops."""
        build = (build_net_apply if self.cfg.split_program
                 else build_net_apply_legacy)
        self._gen_apply = build(self.groups, "G")
        self._disc_apply = build(self.groups, "D", capture_middle=True)

    # -- generation for evaluation ------------------------------------------
    def generate(self, n_per_client_batch: int, labels: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Generate len(labels) images by cycling clients: ([N, 28, 28, 1]
        images, [N] labels), with the generator's split program in eval
        mode."""
        labels = np.asarray(labels)
        n_total = len(labels)
        g_params = self.state["G"]
        imgs_all, labels_all = [], []
        pos = 0
        while pos < n_total:
            # each group consumes the next contiguous label chunk (a
            # shared cursor: groups never recycle each other's labels);
            # only the final partial chunk pads, and the padding is
            # sliced off below
            inputs, ys = {}, {}
            cursor = pos
            for g in self.groups:
                need = min(n_per_client_batch, max(1, (n_total - pos)
                                                   // max(1, g.size)))
                cnt = g.size * need
                chunk = labels[cursor:cursor + cnt]
                if chunk.shape[0] < cnt:
                    chunk = np.concatenate(
                        [chunk, np.zeros(cnt - chunk.shape[0],
                                         labels.dtype)])
                cursor += cnt
                z = self._rng.normal(0, 1, (g.size, need, Z_DIM)
                                     ).astype(np.float32)
                ys[g.name] = chunk.reshape(g.size, need).astype(np.int32)
                inputs[g.name] = (torch.as_tensor(z, device=self.device),
                                  torch.as_tensor(ys[g.name],
                                                  device=self.device))
            with torch.no_grad():
                out, _, _, _ = self._gen_apply(g_params["client"],
                                               g_params["server"], inputs,
                                               False)
            for g in self.groups:
                imgs_all.append(out[g.name].reshape(-1, 28, 28, 1).cpu()
                                .numpy())
                labels_all.append(ys[g.name].reshape(-1))
            pos = cursor
        imgs = np.concatenate(imgs_all)[:n_total]
        labs = np.concatenate(labels_all)[:n_total]
        return imgs, labs
