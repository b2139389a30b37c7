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

Client-sharded training (``fed_mesh=``, a ``DeviceMesh`` from
``launch.mesh.make_federation_mesh``; every rank of the mesh builds the
same trainer). When the mesh's data axes divide every profile group's
size (``data.pipeline.step_client_axes``), the step shards as the
reference's partitions by client rows (``step_sharded``): rank r of n
keeps block r of every group's rows (``sharding.policy.row_block``) of
the dataset, the client parameters, Adam's moments and the
middle-activation EMA, and runs those clients' heads and tails and their
rows of every server layer. The server's parameters and moments are
replicated: each server BatchNorm sums its statistics over the ranks
(``launch.mesh.reduce_sum``, whose backward sums again), and the server's
gradients are summed over the ranks in one call per net before Adam, so
every rank applies the same update. Each rank draws the whole batch and
keeps its rows, so the step equals the unsharded one up to the order of
the reduced sums. Rounds run on the rank's own rows
(``core.federation``, ``local_rows``); the clustering reads the gathered
EMA, and the first rank's labels, weights, k and cohort are broadcast.
``generate``, ``whole_state``/``load_whole_state``, checkpoints and
every regroup gather the whole state, run the unsharded code and keep
the rows of the (new) grouping (``_whole``). A sharded step's fused
epoch runs its all-reduces inside ``launch.mesh.graph_collectives``:
between ranks that share one card through the shared all-reduce kernel
(``kernels.shared_allreduce``), which the epoch's CUDA graphs capture;
with one GPU per rank through NCCL, captured likewise; on the CPU as
the plain rank-order sum. Gloo ranks on several cards have no such
route, and their fused epoch raises (``fused_epoch=False`` trains
them). The per-step loop, rounds and checkpoints keep the backend's own
collectives.

When a group does not divide, the step is replicated, as the
reference's ``sanitize`` replicates what it cannot split: every rank
holds the whole state and data and runs the same steps, and only the
rounds shard the client rows. Before each such round the first rank
broadcasts its whole state and EMA (``sync_replicas``): the card's
convolution gradients are not deterministic, and replicas that ran the
same steps can differ in their last bits. ``federate(mesh=None)``
forces the single-device round on a trainer with a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, trace
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
from repro_torch.data.pipeline import (sample_batch, stage_clients,
                                       step_client_axes)
from repro_torch.kernels.shared_allreduce import check_error
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import gan, nn
from repro_torch.models.gan import (DISC_LAYER_DEFS, DISC_MIDDLE_FEATURES,
                                    GEN_LAYER_DEFS, Z_DIM)
from repro_torch.optim.optimizers import AdamState, adam
from repro_torch.sharding.policy import data_axes, row_block, shard_index
from repro_torch.tree import tree_from_items, tree_items, tree_leaves, tree_map

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
                    concat_groups: bool = True, reduce=None) -> Callable:
    """Returns ``apply(client_params, server_params, inputs, train) ->
    (outputs {gname: [K, b, ...]}, new_client, new_server, middles)``
    with ``inputs`` = {gname: tuple of per-client-stacked tensors fed to
    layer 0}: the executor of the compiled ``SplitProgram``
    (``core.segments.make_apply``). On a rank of a client-sharded step
    ``groups`` hold the rank's rows and ``reduce`` sums the server's
    BatchNorm statistics over the ranks."""
    return make_apply(compile_split_program(groups, net),
                      capture_middle=capture_middle,
                      concat_groups=concat_groups, reduce=reduce)


def build_net_apply_legacy(groups: Sequence[ProfileGroup], net: str,
                           capture_middle: bool = False,
                           concat_groups: bool = True,
                           reduce=None) -> Callable:
    """``build_net_apply``'s contract without a ``SplitProgram``: the
    reference's legacy hand-rolled per-group loops, which derive each
    server layer's active groups and each group's departure inline from
    the cuts. They issue the program executor's layer calls in the same
    order, so the two agree bit for bit; this one is the oracle behind
    ``HuSCFConfig.split_program=False``. ``concat_groups=False`` is the
    no-concat server schedule (per-group BatchNorm statistics,
    ``core.segments``); ``reduce`` as in ``build_net_apply``."""
    defs = NET_LAYER_DEFS[net]
    n = len(defs)
    middle = n // 2
    span = server_union_span(groups, net, n)

    def apply(client_params, server_params, inputs, train: bool):
        new_client = {g.name: dict(client_params[g.name]) for g in groups}
        new_server = dict(server_params)
        bufs: Dict[str, torch.Tensor] = {}
        for g in groups:
            h, _ = layer_pair(g.cut, net)
            bufs[g.name], upd = head_pass(defs, client_params[g.name],
                                          inputs[g.name], h, train)
            new_client[g.name].update(upd)
        outs: Dict[str, torch.Tensor] = {}
        middles: Dict[str, torch.Tensor] = {}
        for l in span:
            active = [g for g in groups
                      if layer_pair(g.cut, net)[0] <= l
                      < layer_pair(g.cut, net)[1]]
            parts, new_server[str(l)] = server_pass(
                defs[l], server_params[str(l)],
                [bufs[g.name] for g in active], train, concat_groups, reduce)
            for g, part in zip(active, parts):
                bufs[g.name] = part
                if capture_middle and l == middle:
                    middles[g.name] = part.flatten(2).float().mean(1)
                if layer_pair(g.cut, net)[1] == l + 1:
                    outs[g.name] = part
        results: Dict[str, torch.Tensor] = {}
        for g in groups:
            _, t = layer_pair(g.cut, net)
            results[g.name], upd = tail_pass(defs, client_params[g.name],
                                             outs[g.name], t, n, train)
            new_client[g.name].update(upd)
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
    return (None if mask is None
            else trace.readback("cohort.host", mask).numpy())


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


def _no_mark(name: str) -> None:
    pass


# one side stream per device for every trainer's warm-ups and captures:
# cuBLAS keeps a workspace per (handle, stream) for the life of the
# process, so a stream per trainer would leave one behind for each,
# pinning whatever segment of device memory it landed in
_CAPTURE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


class StepClock:
    """CUDA events at the fused step's five points (``POINTS``: its
    start, before the batch is drawn, then after D's gradients, D's Adam
    update, G's gradients and G's Adam update), one set of events for
    each step of the eager warm-up and of every captured graph. In a
    capture they become event-record nodes, which every replay records
    again. ``sets`` holds each graph's event sets, ``last`` those of the
    steps that ran last; ``phases()`` gives the device milliseconds
    between the points of the last of them, once its events completed
    (after the epoch's readback): no synchronisation of its own."""
    POINTS = ("start", "grad_d", "adam_d", "grad_g", "adam_g")

    def __init__(self):
        self.sets: Dict[Any, List[Dict[str, Any]]] = {}
        self.last: List[Dict[str, Any]] = []
        self._open: Optional[List[Dict[str, Any]]] = None

    @contextlib.contextmanager
    def record(self):
        """Yields the event sets that the steps run (warm-up) or
        captured inside record into, one a step."""
        self._open = []
        try:
            yield self._open
        finally:
            self._open = None

    def mark(self, name: str) -> None:
        if self._open is None:
            return
        if name == self.POINTS[0]:
            self._open.append({p: torch.cuda.Event(enable_timing=True,
                                                   external=True)
                               for p in self.POINTS})
        self._open[-1][name].record()

    def phases(self) -> Optional[Dict[str, float]]:
        """{grad_d, adam_d, grad_g, adam_g: device ms} of the last
        step that ran, or None."""
        if not self.last:
            return None
        ev = self.last[-1]
        return {b: ev[a].elapsed_time(ev[b])
                for a, b in zip(self.POINTS, self.POINTS[1:])}


class GraphPool:
    """What the fused epochs of one trainer share on the card: the side
    stream they warm up and capture on, the private memory pool of their
    CUDA graphs, whether the eager warm-up step has run since the graphs
    were last dropped, the capture seconds and pool bytes so far (the
    device memory the captures reserved) and the steps' ``StepClock``."""

    def __init__(self, device: torch.device):
        index = torch.device(device).index or 0
        if index not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
        self.stream = _CAPTURE_STREAMS[index]
        self.clock = StepClock()
        self.clear()

    def clear(self) -> None:
        """Forget the pool and the warm-up; the graphs themselves belong
        to the epoch functions, which the trainer drops beside."""
        self.pool = None
        self.warm = False
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.graphs = 0
        self.clock.sets.clear()
        self.clock.last = []

    def warm_up(self, step: Callable[[], None]) -> None:
        """One eager step on the capture stream: a real step, and the
        warm-up that initialises what cuDNN, cuBLAS and autograd create
        lazily before a capture may run them."""
        s, cur = self.stream, torch.cuda.current_stream(self.stream.device)
        s.wait_stream(cur)
        with self.clock.record() as sets, torch.cuda.stream(s):
            step()
        cur.wait_stream(s)
        self.clock.last = sets
        self.warm = True

    def capture(self, run: Callable[[], None], gen: torch.Generator,
                steps: int) -> "torch.cuda.CUDAGraph":
        """``run`` (``steps`` steps) captured as a CUDA graph in the
        shared pool, with ``gen`` registered so that each replay advances
        it as running ``run`` eagerly would. A capture that fails
        raises."""
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(gen)
        dev = self.stream.device
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        with trace.span("huscf.graphs.capture", steps=steps) as sp:
            copies = nn.layout_copies
            with trace.paused(), self.clock.record() as sets, \
                    torch.cuda.graph(g, pool=self.pool, stream=self.stream):
                run()
            torch.cuda.synchronize(dev)
            sp.attrs["layout_copies"] = (nn.layout_copies - copies) // steps
        self.capture_s += sp.seconds
        self.pool_bytes += torch.cuda.memory_reserved(dev) - before
        self.clock.sets[g] = sets
        self.graphs += 1
        if self.pool is None:
            self.pool = g.pool()
        return g

    def replay(self, graphs: Sequence[Any]) -> None:
        """Replay ``graphs`` in order, with every host synchronisation an
        error (torch's sync debug mode) while they are launched."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with trace.span("huscf.train_steps.launch"):
                for g in graphs:
                    g.replay()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        if graphs:
            self.clock.last = self.clock.sets[graphs[-1]]


def make_epoch_fn(groups: Sequence[ProfileGroup], step_core: Callable,
                  sample: Callable, n_steps: int, unroll: int = 1,
                  graphs: Optional[GraphPool] = None,
                  rows: Optional[Dict[str, torch.Tensor]] = None,
                  mark: Callable[[str], None] = _no_mark) -> Callable:
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

    ``rows`` are each group's EMA rows (default: its client ids; a
    client-sharded step's EMA holds the rank's rows only). ``mark(name)``
    is called with ``"start"`` before each step draws its batch (the
    trainer's ``StepClock``; ``step_core`` marks the step's later
    points).
    """
    unroll = max(1, min(n_steps, unroll))
    rows = dict(rows or {})
    captured: Dict[int, Any] = {}
    carry_ref: List[Any] = []

    def body(state, gen, ema, ema_init, losses):
        mark("start")
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
            with trace.span("huscf.train_steps.launch") as sp:
                copies = nn.layout_copies
                for _ in range(n_steps):
                    body(*args)
                sp.attrs["layout_copies"] = \
                    (nn.layout_copies - copies) // max(n_steps, 1)
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
                    lambda k=k, own=own: [body(*own) for _ in range(k)], gen,
                    steps=k)
        graphs.replay([captured[k] for k in sizes])
        return losses

    return epoch


def gan_train_step(st: Dict[str, Any], batch: Dict[str, Dict[str, Any]], *,
                   step_groups: Sequence[ProfileGroup], total_clients: int,
                   gen_apply: Callable, disc_apply: Callable,
                   opt_update: Callable, mesh=None, axes=None,
                   inplace: bool = False,
                   mark: Callable[[str], None] = _no_mark):
    """One D then G update from ``st`` on ``batch``: returns (the new
    state, the losses, the middle activations). ``inplace`` writes the
    new parameters, statistics, moments and steps into ``st``'s own
    tensors, one leaf at a time, and returns ``st``.

    ``step_groups`` are the groups whose rows this rank runs, with the
    executors ``gen_apply``/``disc_apply`` built for them. On a sharded
    step (``axes`` not None: the mesh axes the rows shard over) ``batch``
    holds this rank's rows, the server's gradients are summed over the
    ranks in one collective per net (every replica applies the same
    update), and the losses returned are summed over the ranks. The
    trainer's step (``HuSCFTrainer._step``) and the dry run's
    (``launch.dryrun_paper``) are this function. ``mark(name)`` is
    called after D's gradients (``"grad_d"``), D's Adam update and
    BatchNorm merge (``"adam_d"``), G's gradients (``"grad_g"``) and
    G's update (``"adam_g"``): the points of the trainer's
    ``StepClock`` on the card."""
    groups = step_groups
    sharded = axes is not None

    def mean_client_loss(logits: Dict[str, torch.Tensor],
                         target: float) -> torch.Tensor:
        # the mean over all clients of each client's mean BCE; on a
        # sharded step this rank's clients' share of it (their sum over
        # the global client count), whose sum over the ranks is the loss
        tot = 0.0
        for g in groups:
            tot = tot + gan.bce_logits(logits[g.name].reshape(-1),
                                       target) * g.size
        return tot / total_clients

    def sum_server_grads(grads: Dict[str, Any]) -> None:
        if sharded:
            mesh_mod.all_reduce_flat(tree_leaves(grads["server"]), mesh,
                                     axes)

    g_params, d_params = st["G"], st["D"]
    gen_in = {g.name: (batch["z"][g.name], batch["fake_y"][g.name])
              for g in groups}

    # ---------------- discriminator update (G detached)
    with torch.no_grad():
        fake, _, _, _ = gen_apply(g_params["client"], g_params["server"],
                                  gen_in, True)

    def d_loss(d_p):
        lr_, ncr, nsr, mids = disc_apply(
            d_p["client"], d_p["server"],
            {g.name: (batch["real_img"][g.name], batch["real_y"][g.name])
             for g in groups}, True)
        lf_, _, _, _ = disc_apply(
            d_p["client"], d_p["server"],
            {g.name: (fake[g.name], batch["fake_y"][g.name])
             for g in groups}, True)
        loss = mean_client_loss(lr_, 1.0) + mean_client_loss(lf_, 0.0)
        return loss, ({"client": ncr, "server": nsr}, mids)

    loss_d, (d_bn, mids), grads_d = value_and_grad(d_loss, d_params)
    sum_server_grads(grads_d)
    mark("grad_d")
    opt_d, d_new = opt_update(st["opt_d"], grads_d, d_params,
                              inplace=inplace)
    del grads_d
    # keep BatchNorm running stats from the real-data pass
    if inplace:
        merge_bn_(d_new, d_bn)
    else:
        d_new = merge_bn(d_new, d_bn)
    mark("adam_d")

    # ---------------- generator update (vs updated D)
    def g_loss(g_p):
        fake, ncg, nsg, _ = gen_apply(g_p["client"], g_p["server"],
                                      gen_in, True)
        logits, _, _, _ = disc_apply(
            d_new["client"], d_new["server"],
            {g.name: (fake[g.name], batch["fake_y"][g.name])
             for g in groups}, True)
        return (mean_client_loss(logits, 1.0),
                {"client": ncg, "server": nsg})

    loss_g, g_bn, grads_g = value_and_grad(g_loss, g_params)
    sum_server_grads(grads_g)
    mark("grad_g")
    opt_g, g_new = opt_update(st["opt_g"], grads_g, g_params,
                              inplace=inplace)
    del grads_g
    if inplace:
        merge_bn_(g_new, g_bn)
    else:
        g_new = merge_bn(g_new, g_bn)
    mark("adam_g")
    if sharded:
        both = mesh_mod.all_reduce_sum(torch.stack([loss_d, loss_g]),
                                       mesh, axes)
        loss_d, loss_g = both[0], both[1]
    metrics = {"loss_d": loss_d, "loss_g": loss_g}
    if inplace:
        return st, metrics, mids
    return ({"G": g_new, "D": d_new, "opt_g": opt_g, "opt_d": opt_d,
             "step": st["step"] + 1}, metrics, mids)


class HuSCFTrainer:
    """End-to-end HuSCF-GAN over a client population.

    ``batch_source``: optional callable returning the next training
    batch ({"real_img", "real_y", "z", "fake_y"} -> {gname: tensor});
    without it batches are drawn on the device from the staged dataset.
    A host callable cannot be replayed, so on the card it needs
    ``fused_epoch=False``. It returns whole batches; a client-sharded
    trainer keeps its rows of them.

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

    ``step_sharded`` says whether the step runs on this rank's rows of a
    ``fed_mesh`` (see the module docstring); it follows from the mesh
    and the groups, and a regroup may switch it.
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
        # fed_mesh: a DeviceMesh for the client-sharded step and rounds
        # (launch.mesh.make_federation_mesh); None = one device. It is a
        # topology, so it rides the trainer, not the config
        mesh_mod.check_mesh(fed_mesh)
        self.fed_mesh = fed_mesh
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
            with trace.span("huscf.init.cut_search") as sp:
                result = optimize_cuts(self.devices, server,
                                       batch=config.batch,
                                       config=self._ga_config,
                                       device=self.device)
            self.ga_seconds = sp.seconds
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
        self._set_layout()
        self.state = self._init_state(
            torch.Generator().manual_seed(config.seed))
        self._dataset = stage_clients(self.groups, self.clients, self.device,
                                      mesh=fed_mesh)
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
        self._mid_ema = torch.zeros((len(self._local_ids),
                                     DISC_MIDDLE_FEATURES),
                                    dtype=torch.float32, device=self.device)
        self._ema_init = False           # host mirror of the device flag
        # the fused epoch's own carry: the EMA's device flag, the last
        # step's losses, and the fixed tensors its steps write into
        self._ema_flag = torch.zeros((), dtype=torch.bool, device=self.device)
        self._losses = {k: torch.zeros((), device=self.device)
                        for k in ("loss_d", "loss_g")}
        self._carry: Optional[List] = None
        self._carry_inputs: Tuple = ()
        # a sharded step's fused-epoch collectives (made at its first
        # fused epoch, released with the graphs)
        self._graph_coll: Optional[mesh_mod.GraphCollectives] = None
        self._sizes_dev = torch.as_tensor(self.sizes, dtype=torch.float32,
                                          device=self.device)
        self._fed_plans: Dict = {}
        self._round_mesh = None          # the sharded mesh of this round
        self.fed_round = 0
        self.epoch = 0
        self.history: List[Dict[str, float]] = []
        self.fed_log: List[Dict[str, Any]] = []

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- the step's layout over a mesh --------------------------------------
    @property
    def step_sharded(self) -> bool:
        """The step runs this rank's rows of every group (the mesh's data
        axes divide every group's size); False: every rank holds and runs
        all of them."""
        return self._shard_axes is not None

    def _set_layout(self, whole: bool = False) -> None:
        """Lay the step out for the current groups and mesh: on a sharded
        step (``data.pipeline.step_client_axes``) this rank runs block r
        of every group's rows (``policy.row_block``), whose EMA rows are
        the rank's, in group order; otherwise every row, with the EMA
        indexed by global client id. ``whole`` lays out every row, for
        the gathered state of ``_whole``. Rebuilds both nets' executors."""
        mesh = self.fed_mesh
        axes = None if whole else step_client_axes(self.groups, mesh)
        self._shard_axes = axes
        self._blocks = {g.name: row_block(mesh, g.size, axes)
                        for g in self.groups}
        self._step_groups = list(self.groups) if axes is None else [
            dataclasses.replace(g, client_ids=g.client_ids[lo:hi])
            for g in self.groups for lo, hi in [self._blocks[g.name]]]
        self._local_ids = [c for g in self._step_groups for c in g.client_ids]
        if axes is None:
            self._rows = {g.name: self._index(g.client_ids)
                          for g in self.groups}
        else:
            off, self._rows = 0, {}
            for g in self._step_groups:
                self._rows[g.name] = torch.arange(off, off + g.size,
                                                  device=self.device)
                off += g.size
        self._reduce = (None if axes is None else functools.partial(
            mesh_mod.reduce_sum, mesh=mesh, axes=axes))
        self._build_applies()

    @staticmethod
    def _is_rows(path: Tuple[str, ...]) -> bool:
        """A client stack of the state (parameters or Adam's moments):
        ``(net, "client", ...)`` or ``(opt, "mu" | "nu", "client",
        ...)``."""
        return "client" in path[1:3]

    def _gather(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The whole state from every rank's rows (a collective)."""
        return _state_from_carry(mesh_mod.gather_state(
            _carry_items(state), self.fed_mesh, self._shard_axes,
            self._is_rows), state["step"])

    def _keep(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a whole state."""
        return _state_from_carry(mesh_mod.keep_rows(
            _carry_items(state), self.fed_mesh, self._shard_axes,
            self._is_rows), state["step"])

    def _whole_ema(self) -> torch.Tensor:
        """The whole ``[K, F]`` EMA, rows by global client id (on a
        sharded step a collective: every group's rows gathered)."""
        if not self.step_sharded:
            return self._mid_ema
        parts = list(torch.split(self._mid_ema,
                                 [g.size for g in self._step_groups]))
        whole = torch.empty((len(self.clients), self._mid_ema.shape[1]),
                            dtype=self._mid_ema.dtype, device=self.device)
        for g, x in zip(self.groups, mesh_mod.all_gather_rows(
                parts, self.fed_mesh, self._shard_axes)):
            whole.index_copy_(0, self._index(g.client_ids), x)
        return whole

    def _lay_out(self, sync: bool = False) -> None:
        """``_set_layout`` for the current groups, with the state and EMA
        whole; when the step shards they keep this rank's rows, after
        the first rank's whole state is broadcast with ``sync`` (replicas
        that trained apart)."""
        self._set_layout()
        if self.step_sharded:
            if sync:
                self.sync_replicas(self.fed_mesh)
            self.state = self._keep(self.state)
            self._mid_ema = self._mid_ema.index_select(
                0, self._index(self._local_ids))

    @contextlib.contextmanager
    def _whole(self):
        """Run unsharded code on the whole state: a sharded trainer
        gathers its state and EMA and lays out every row (every rank of
        the mesh enters), and on leaving keeps the rows of the grouping
        the body left, which may have changed (or need none: a grouping
        that does not divide replicates). Nothing happens on a trainer
        whose step does not shard."""
        if not self.step_sharded:
            yield
            return
        self.state, self._mid_ema = self._gather(self.state), self._whole_ema()
        self._set_layout(whole=True)
        try:
            yield
        finally:
            self._lay_out()

    def whole_state(self) -> Dict[str, Any]:
        """The trainer's state with every client row (a sharded trainer
        gathers it: every rank of the mesh calls this), e.g. for
        ``bridge.state_to_numpy``."""
        return self._gather(self.state) if self.step_sharded else self.state

    def load_whole_state(self, state: Dict[str, Any],
                         ema: Optional[torch.Tensor] = None) -> None:
        """Replace the state (and the ``[K, F]`` EMA) with whole ones; a
        sharded trainer keeps its rows."""
        self.state = self._keep(state) if self.step_sharded else state
        if ema is not None:
            self._mid_ema = (ema.index_select(0, self._index(self._local_ids))
                             if self.step_sharded else ema)
            self._ema_init = True

    def _is_first(self) -> bool:
        """This rank writes what the mesh's ranks share (the first along
        its data axes; the only one without a mesh)."""
        mesh = self.fed_mesh
        return (mesh is None or mesh.size() == 1 or
                shard_index(mesh, data_axes(mesh))[0] == 0)

    def save_checkpoint(self, path: str) -> None:
        """Write the whole state in the reference's checkpoint format
        (``checkpoint.save_checkpoint``), at the epoch; every rank of a
        mesh calls it, its first rank writes, and every rank returns once
        the file is written."""
        from repro_torch.bridge import state_to_numpy
        from repro_torch.checkpoint import save_checkpoint
        whole = self.whole_state()
        if self._is_first():
            save_checkpoint(path, state_to_numpy(whole), step=self.epoch)
        mesh_mod.barrier(self.fed_mesh)   # written before any rank reads

    def load_checkpoint(self, path: str) -> int:
        """Load a whole state written by ``save_checkpoint`` (or the
        reference); a sharded trainer keeps its rows. Returns the step
        the file records."""
        from repro_torch.bridge import state_from_numpy, state_to_numpy
        from repro_torch.checkpoint import load_checkpoint
        back, step = load_checkpoint(path, state_to_numpy(self.whole_state()))
        self.load_whole_state(state_from_numpy(back, self.device))
        return step

    # -- initialization ----------------------------------------------------
    def _init_state(self, gen: torch.Generator) -> Dict[str, Any]:
        """The whole state's draws from ``gen`` (the unsharded trainer's),
        of which a sharded step keeps this rank's rows, group by group."""
        with trace.span("huscf.init.state"):
            return self._draw_state(gen)

    def _draw_state(self, gen: torch.Generator) -> Dict[str, Any]:
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
                client[g.name] = tree_from_items(mesh_mod.keep_rows(
                    list(tree_items({str(l): defs[l].init(g.size, gen, dev)
                                     for l in list(range(h))
                                     + list(range(t, n))})),
                    self.fed_mesh, self._shard_axes, lambda _: True))
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
    def _step(self, st: Dict[str, Any], batch: Dict[str, Dict[str, Any]],
              inplace: bool = False, mark: Callable[[str], None] = _no_mark):
        """One D then G update from ``st`` on ``batch``
        (``gan_train_step`` with this trainer's groups, executors,
        optimizer and mesh layout)."""
        return gan_train_step(
            st, batch, step_groups=self._step_groups,
            total_clients=sum(g.size for g in self.groups),
            gen_apply=self._gen_apply, disc_apply=self._disc_apply,
            opt_update=self._opt_update, mesh=self.fed_mesh,
            axes=self._shard_axes, inplace=inplace, mark=mark)

    def _sample(self, gen: torch.Generator):
        """One training batch: the ``batch_source``'s next (this rank's
        rows of it on a sharded step), else drawn on the device from the
        staged dataset with ``gen``."""
        if self._batch_source is not None:
            batch = self._batch_source()
            if not self.step_sharded:
                return batch
            return {f: {g: x[slice(*self._blocks[g])] for g, x in d.items()}
                    for f, d in batch.items()}
        return sample_batch(self._dataset, gen, batch=self.cfg.batch,
                            z_dim=Z_DIM, num_classes=gan.NUM_CLASSES)

    # -- the fused epoch -----------------------------------------------------
    def _build_epoch(self, n_steps: int) -> Callable:
        # the epoch lives in self._epoch_fns, so it holds the trainer
        # weakly: a cycle would keep the state and the graphs' pool on
        # the card until the garbage collector found it
        me = weakref.proxy(self)
        # the card's pool times the steps' phases (a stand-in pool of the
        # CPU tests has no clock)
        clock = getattr(self._graph_pool, "clock", None)
        mark = _no_mark if clock is None else clock.mark
        return make_epoch_fn(
            self._step_groups,
            lambda st, b: me._step(st, b, inplace=True, mark=mark)[1:],
            lambda gen: me._sample(gen), n_steps,
            unroll=self.cfg.epoch_unroll or 1, graphs=self._graph_pool,
            rows=self._rows, mark=mark)

    def _drop_graphs(self) -> None:
        """Everything captured on the old carry or grouping goes: the
        epoch functions with their graphs, the pool, the warm-up and a
        sharded step's collective buffers (the reference's
        ``_epoch_fns.clear()``)."""
        self._epoch_fns.clear()
        self._carry = None
        if self._graph_pool is not None:
            self._graph_pool.clear()
        if self._graph_coll is not None:
            # the graphs baked the collectives' buffers in (a collective:
            # every rank of the mesh drops its graphs together)
            self._graph_coll.release()
            self._graph_coll = None

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
        with trace.span("huscf.train_steps.adopt"):
            self._adopt_carry()
        if self.step_sharded and self._graph_coll is None:
            # a collective: every rank of the mesh is in this epoch;
            # gloo ranks on several cards raise here
            self._graph_coll = mesh_mod.GraphCollectives(
                self.fed_mesh, self._shard_axes, self.device)
        fn = self._epoch_fns.get(n_steps)
        if fn is None:
            fn = self._epoch_fns[n_steps] = self._build_epoch(n_steps)
        self._ema_flag.fill_(self._ema_init)
        with mesh_mod.graph_collectives(
                self._graph_coll if self.step_sharded else None):
            fn(self.state, self._train_gen, self._mid_ema, self._ema_flag,
               self._losses)
        self._ema_init = True
        self.state["step"] += n_steps
        return self._losses

    # -- public API ----------------------------------------------------------
    def train_steps(self, n_steps: int) -> Dict[str, float]:
        with trace.span("huscf.train_steps", steps=n_steps):
            if self.cfg.fused_epoch:
                return self._fused_steps(n_steps)
            return self._loop_steps(n_steps)

    def _fused_steps(self, n_steps: int) -> Dict[str, float]:
        losses = self._fused_epoch(n_steps)
        back = torch.stack(list(losses.values()))
        words = (None if self._graph_coll is None
                 else self._graph_coll.error_words())
        if words is not None:
            # the losses and the shared all-reduce's error words, in one
            # readback (float64 holds the int32 words exactly)
            back = torch.cat([back.double(), words.double()])
        with trace.span("huscf.train_steps.readback"):
            back = back.tolist()             # the epoch's one readback
        # the card is idle now: the last step's phases read no further
        clock = getattr(self._graph_pool, "clock", None)
        phases = None if clock is None else clock.phases()
        for name, ms in (phases or {}).items():
            trace.event("huscf.step." + name, ms=ms)
        for i in range(len(losses), len(back), 5):
            check_error(back[i:i + 5])
        return dict(zip(losses, back))

    def _loop_steps(self, n_steps: int) -> Dict[str, float]:
        metrics = {}
        for _ in range(n_steps):
            self.state, metrics, mids = self._step(
                self.state, self._sample(self._train_gen))
            # middle-activation EMA, one [K, F] row per global client (a
            # sharded step's rows: this rank's)
            for g in self._step_groups:
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
        """The whole ``[K, F]`` EMA on the host (a sharded trainer gathers
        it: every rank of the mesh calls this)."""
        if not self._ema_init:
            raise RuntimeError("middle_activations() before any training "
                               "step: the EMA is empty")
        return trace.readback("ema.host",
                              self._whole_ema().detach()).clone().numpy()

    _MESH_DEFAULT = object()     # sentinel: mesh=None must stay sayable

    def federate(self, use_label_kld: bool = False,
                 init_centers: Optional[Dict[int, torch.Tensor]] = None,
                 cohort_ids: Optional[torch.Tensor] = None,
                 mesh: Any = _MESH_DEFAULT) -> Dict[str, Any]:
        """Stages 3+4; returns diagnostics.

        With ``cfg.cohort_size`` each round first samples its cohort from
        the registry; Eq. 15 weights renormalize over the cohort and
        non-members keep their params. ``cfg.agg_chunk`` streams every
        aggregation in client chunks. The clustered round runs on the
        device unless ``cfg.fused_cluster`` is False or
        ``use_label_kld`` is set, which take the host numpy path.

        ``mesh`` overrides the trainer's ``fed_mesh`` for this round;
        ``mesh=None`` forces the single-device round (a sharded trainer
        runs it on its gathered state, ``_whole``). On a mesh of more
        than one rank every rank of it calls ``federate``. A sharded
        trainer rounds its own rows; a replicated one first takes the
        first rank's state (``sync_replicas``).

        Tests feed the reference's draws: ``init_centers`` maps each
        candidate k to the k-means++ centres of the device path, and
        ``cohort_ids`` replaces this round's cohort draw."""
        mesh = self.fed_mesh if mesh is self._MESH_DEFAULT else mesh
        mesh_mod.check_mesh(mesh)
        if self.step_sharded and \
                mesh_mod.mesh_key(mesh) != mesh_mod.mesh_key(self.fed_mesh):
            with self._whole():
                return self.federate(use_label_kld, init_centers, cohort_ids,
                                     mesh)
        with trace.span("huscf.federate") as sp:
            diag = self._round(mesh, use_label_kld, init_centers, cohort_ids)
            sp.attrs["mode"] = diag["mode"]
        return diag

    def _round(self, mesh, use_label_kld: bool, init_centers, cohort_ids
               ) -> Dict[str, Any]:
        """``federate``'s round on ``mesh`` (None: one device)."""
        self._round_mesh = mesh if mesh is not None and mesh.size() > 1 \
            else None
        if self._round_mesh is not None and not self.step_sharded:
            self.sync_replicas(self._round_mesh)
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
            if self._round_mesh is not None:
                mesh_mod.broadcast_from_first([cohort_ids], self._round_mesh)
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
            plans = len(self._fed_plans)
            with trace.span("huscf.federate.aggregate", net=net) as sp:
                out = federate_fn(self.groups, wrapped, *args,
                                  n_layers={net: N_LAYERS[net]},
                                  use_kernel=self.cfg.use_kernel,
                                  plan_cache=self._fed_plans,
                                  chunk_size=self.cfg.agg_chunk,
                                  mesh=self._round_mesh,
                                  local_rows=self.step_sharded, **kwargs)
                sp.attrs["plan_built"] = len(self._fed_plans) > plans
            self.state[net]["client"] = {g.name: out[g.name][net]
                                         for g in self.groups}

    def sync_replicas(self, mesh) -> None:
        """Overwrite this rank's trainer state and middle-activation EMA,
        in place, with the mesh's first rank's (one broadcast per
        dtype). In place, the fused epoch's captured graphs keep reading
        the same tensors. Replicas only: a sharded step's rows differ by
        rank, and its server replicas never drift."""
        tensors = [x for _, x in _carry_items(self.state)]
        mesh_mod.broadcast_flat(tensors + [self._mid_ema], mesh)

    def _federate_clustered(self, init_centers, cohort_mask
                            ) -> Dict[str, Any]:
        if not self._ema_init:
            raise RuntimeError("federate() before any training step: the "
                               "middle-activation EMA is empty")
        acts = self._whole_ema()
        with trace.span("huscf.federate.cluster"):
            labels, k_sel, sil = cluster_activations(
                acts, k=self.cfg.num_clusters, use_kernel=self.cfg.use_kernel,
                gen=self._cluster_gen, init_centers=init_centers)
        bound = k_selection_bound(len(self.clients), self.cfg.num_clusters)
        with trace.span("huscf.federate.kld"):
            weights, klds = kld_mod.activation_weights(
                acts, self._sizes_dev, labels, bound, self.cfg.beta,
                cohort_mask=cohort_mask)
        if self._round_mesh is not None:
            # the first rank's clustering for every rank of the round
            ks = torch.tensor([float(k_sel), float(sil)], dtype=torch.float64,
                              device=self.device)
            mesh_mod.broadcast_from_first([labels, weights, klds, ks],
                                          self._round_mesh)
            k_sel, sil = trace.readback("cluster.broadcast", ks).tolist()
            k_sel = int(k_sel)
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
        with trace.span("huscf.federate.cluster"):
            cl = cluster_activations_np(acts, k=self.cfg.num_clusters,
                                        seed=self.cfg.seed)
        with trace.span("huscf.federate.kld"):
            if use_label_kld:
                hists = np.stack([np.bincount(c.labels,
                                              minlength=gan.NUM_CLASSES)
                                  for c in self.clients])
                weights, klds = kld_mod.label_weights(
                    hists, self.sizes, cl.labels, self.cfg.beta)
            else:
                weights, klds = kld_mod.activation_weights_np(
                    acts, self.sizes, cl.labels, self.cfg.beta)
            if cohort_mask is not None:
                weights = kld_mod.cohort_federation_weights_np(
                    klds, self.sizes, cl.labels, cohort_mask, self.cfg.beta)
        k_sel, sil, labels = cl.k, cl.silhouette, cl.labels
        if self._round_mesh is not None:
            # the first rank's clustering for every rank of the round
            t = [torch.as_tensor(np.asarray(a, np.float64), device=self.device)
                 for a in (labels, weights, klds, [k_sel, sil])]
            mesh_mod.broadcast_from_first(t, self._round_mesh)
            labels, weights, klds = (
                trace.readback("cluster.broadcast", x).numpy().astype(a.dtype)
                for x, a in zip(t[:3], (np.asarray(labels),
                                        np.asarray(weights),
                                        np.asarray(klds))))
            k_sel, sil = trace.readback("cluster.broadcast", t[3]).tolist()
            k_sel = int(k_sel)
        self._federate_nets(federate_client_params, weights, labels,
                            cohort_mask=cohort_mask)
        return {"round": self.fed_round, "mode": "clustered", "k": k_sel,
                "silhouette": sil, "labels": labels,
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
        (its keys hold the old groups). It runs on the whole state
        (``_whole``); the new grouping's layout decides whether the step
        shards, and a replicated trainer that starts to shard first takes
        the first rank's state."""
        was_sharded = self.step_sharded
        with self._whole():
            self._regroup(new_clients, new_devices, new_cuts, old_of)
        if not was_sharded:
            self._lay_out(sync=True)

    def _regroup(self, new_clients: Sequence[ClientSpec],
                 new_devices: Sequence[DeviceProfile],
                 new_cuts: Sequence[Cut], old_of: Sequence[int]) -> None:
        """``_rebuild_population``'s body on the whole state."""
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
        self._dataset = stage_clients(self.groups, self.clients, self.device,
                                      mesh=self.fed_mesh)
        self.state = new_state
        self._mid_ema = new_ema
        self._sizes_dev = torch.as_tensor(self.sizes, dtype=torch.float32,
                                          device=self.device)
        # everything keyed on the old grouping is stale
        self._fed_plans.clear()
        self._drop_graphs()

    def _build_applies(self) -> None:
        """Both nets' executors for the step's groups (a sharded step's:
        this rank's rows, the server's statistics summed over the ranks):
        the compiled program, or with ``cfg.split_program=False`` the
        legacy loops."""
        build = (build_net_apply if self.cfg.split_program
                 else build_net_apply_legacy)
        self._gen_apply = build(self._step_groups, "G", reduce=self._reduce)
        self._disc_apply = build(self._step_groups, "D", capture_middle=True,
                                 reduce=self._reduce)

    # -- generation for evaluation ------------------------------------------
    def generate(self, n_per_client_batch: int, labels: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Generate len(labels) images by cycling clients: ([N, 28, 28, 1]
        images, [N] labels), with the generator's split program in eval
        mode (a sharded trainer on its gathered state: every rank of the
        mesh calls this, and each gets every image)."""
        with self._whole():
            return self._generate(n_per_client_batch, labels)

    def _generate(self, n_per_client_batch: int, labels: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
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
