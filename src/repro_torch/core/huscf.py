"""HuSCF-GAN trainer — the paper's five-stage procedure (§4.1), in
PyTorch (port of ``repro.core.huscf``).

1. GA cut selection from device capabilities (host numpy GA).
2. Heterogeneous U-shaped split training of G and D (``core.segments``).
3. Every E epochs: k-means on the discriminator's middle-activation EMA.
4. Log-space KLD weights, then the clustered Eq.-16 aggregation of the
   client segments; vanilla FedAvg for the first warm-up rounds.

Stages 3 and 4 run on the device; with ``use_kernel`` (the default
here) the assignment step of k-means is kernel K2 and every
aggregation is kernel K1.

``generate`` runs the generator's split program in eval mode.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: cohorts, chunked aggregation, online re-cut and churn,
mesh-sharded federation, the host clustering path
(``fused_cluster=False``) and label-histogram KLD.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kld as kld_mod
from repro_torch.core.clustering import cluster_activations, k_selection_bound
from repro_torch.core.federation import (N_LAYERS,
                                         federate_client_params_device,
                                         fedavg_uniform)
from repro_torch.core.genetic import GAConfig, optimize_cuts
from repro_torch.core.latency import (Cut, DeviceProfile, PAPER_DEVICES,
                                      PAPER_SERVER, huscf_iteration_latency)
from repro_torch.core.segments import compile_split_program, make_apply
from repro_torch.core.splitting import group_by_profile, server_union_span
from repro_torch.data.partition import ClientSpec
from repro_torch.data.pipeline import sample_batch, stage_clients
from repro_torch.models import gan
from repro_torch.models.gan import (DISC_LAYER_DEFS, DISC_MIDDLE_FEATURES,
                                    GEN_LAYER_DEFS, Z_DIM)
from repro_torch.optim.optimizers import adam
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
    fused_cluster: bool = True       # False (host numpy path): ROADMAP M5b
    cohort_size: Optional[int] = None        # ROADMAP M6b, cohorts
    agg_chunk: Optional[int] = None          # ROADMAP M6c, chunked stream
    reoptimize_every: Optional[int] = None   # ROADMAP M9b, online re-cut


def _check_supported(cfg: HuSCFConfig) -> None:
    if cfg.cohort_size is not None:
        raise NotImplementedError("cohort rounds are not ported yet (ROADMAP "
                                  "M6b, cohorts/registry)")
    if cfg.agg_chunk is not None:
        raise NotImplementedError("chunk-streamed aggregation is not ported "
                                  "yet (ROADMAP M6c, chunked stream)")
    if cfg.reoptimize_every is not None:
        raise NotImplementedError("online re-cut is not ported yet (ROADMAP "
                                  "M9b)")
    if not cfg.fused_cluster:
        raise NotImplementedError("the host numpy clustering path is not "
                                  "ported yet (ROADMAP M5b)")


def merge_bn(updated: Dict, bn: Dict) -> Dict:
    """Optimizer-updated learnables, but BatchNorm running statistics
    (keys 'mean'/'var') from the forward pass."""
    if isinstance(updated, dict):
        return {k: (bn.get(k, v) if k in ("mean", "var") and
                    not isinstance(v, dict) else merge_bn(v, bn.get(k, {})))
                for k, v in updated.items()}
    return updated


def _is_stat(path) -> bool:
    return path[-1] in ("mean", "var")


class HuSCFTrainer:
    """End-to-end HuSCF-GAN over a client population.

    ``batch_source``: optional callable returning the next training
    batch ({"real_img", "real_y", "z", "fake_y"} -> {gname: tensor});
    without it batches are drawn on the device from the staged dataset.
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
        _check_supported(config)
        if fed_mesh is not None:
            raise NotImplementedError("mesh-sharded federation is not "
                                      "ported (ROADMAP M10, mesh code)")
        self.device = resolve_device(device)
        self.clients = list(clients)
        self.cfg = config
        K = len(self.clients)
        if devices is None:
            devices = [PAPER_DEVICES[i % len(PAPER_DEVICES)] for i in range(K)]
        self.devices = list(devices)
        self.server_profile = server

        # Stage 1: GA cut selection
        self._ga_config = ga_config or GAConfig(population_size=200,
                                                generations=30,
                                                seed=config.seed)
        if cuts is None:
            result = optimize_cuts(self.devices, server, batch=config.batch,
                                   config=self._ga_config)
            cuts = result.cuts
            self.ga_latency = result.latency
        else:
            self.ga_latency = huscf_iteration_latency(cuts, self.devices,
                                                      server, config.batch)
        self.cuts = list(cuts)
        self.groups = group_by_profile(self.devices, self.cuts)
        self.sizes = np.array([c.n for c in self.clients], np.int64)

        self._opt_init, self._opt_update = adam(config.lr, b1=config.adam_b1)
        self.state = self._init_state(
            torch.Generator().manual_seed(config.seed))
        self._dataset = stage_clients(self.groups, self.clients, self.device)
        self._batch_source = batch_source
        # generate()'s latent draws: numpy, seeded as in the reference, so
        # one state gives the reference's images
        self._rng = np.random.default_rng(config.seed + 1)
        self._train_gen = self._generator(config.seed + 1)
        self._cluster_gen = self._generator(config.seed + 2)
        self._mid_ema = torch.zeros((K, DISC_MIDDLE_FEATURES),
                                    dtype=torch.float32, device=self.device)
        self._ema_init = False
        self._sizes_dev = torch.as_tensor(self.sizes, dtype=torch.float32,
                                          device=self.device)
        self._rows = {g.name: torch.as_tensor(g.client_ids, device=self.device)
                      for g in self.groups}
        self._fed_plans: Dict = {}
        self._gen_apply = make_apply(compile_split_program(self.groups, "G"))
        self._disc_apply = make_apply(compile_split_program(self.groups, "D"),
                                      capture_middle=True)
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
                "opt_g": self._opt_init(params["G"]),
                "opt_d": self._opt_init(params["D"]), "step": 0}

    # -- one training step ----------------------------------------------------
    def _mean_client_loss(self, logits: Dict[str, torch.Tensor],
                          target: float) -> torch.Tensor:
        total = sum(g.size for g in self.groups)
        tot = 0.0
        for g in self.groups:
            tot = tot + gan.bce_logits(logits[g.name].reshape(-1),
                                       target) * g.size
        return tot / total

    def _grads(self, loss_fn: Callable, params: Dict):
        """(loss, aux, grads) of ``loss_fn(params) -> (loss, aux)`` with
        respect to every learnable leaf; BatchNorm statistics get zero
        gradients, as they do under ``jax.grad``."""
        items = list(tree_items(params))
        learn = {p: x.detach().requires_grad_(True)
                 for p, x in items if not _is_stat(p)}
        loss, aux = loss_fn(tree_from_items(
            (p, learn.get(p, x)) for p, x in items))
        gmap = dict(zip(learn, torch.autograd.grad(loss,
                                                   list(learn.values()))))
        grads = tree_from_items(
            (p, gmap[p] if p in gmap else torch.zeros_like(x))
            for p, x in items)
        return loss.detach(), aux, grads

    def _step(self, batch: Dict[str, Dict[str, torch.Tensor]]):
        groups = self.groups
        st = self.state
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

        loss_d, (d_bn, mids), grads_d = self._grads(d_loss, d_params)
        opt_d, d_new = self._opt_update(st["opt_d"], grads_d, d_params)
        # keep BatchNorm running stats from the real-data pass
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

        loss_g, g_bn, grads_g = self._grads(g_loss, g_params)
        opt_g, g_new = self._opt_update(st["opt_g"], grads_g, g_params)
        g_new = merge_bn(g_new, g_bn)

        self.state = {"G": g_new, "D": d_new, "opt_g": opt_g, "opt_d": opt_d,
                      "step": st["step"] + 1}
        return {"loss_d": loss_d, "loss_g": loss_g}, mids

    def _next_batch(self):
        if self._batch_source is not None:
            return self._batch_source()
        return sample_batch(self._dataset, self._train_gen,
                            batch=self.cfg.batch, z_dim=Z_DIM,
                            num_classes=gan.NUM_CLASSES)

    # -- public API ----------------------------------------------------------
    def train_steps(self, n_steps: int) -> Dict[str, float]:
        metrics = {}
        for _ in range(n_steps):
            metrics, mids = self._step(self._next_batch())
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
                 init_centers: Optional[Dict[int, torch.Tensor]] = None
                 ) -> Dict[str, Any]:
        """Stages 3+4; returns diagnostics. ``init_centers`` maps each
        candidate k to the k-means++ centres to start from (tests feed
        the reference's draws); without it they are drawn from the
        trainer's cluster generator."""
        if use_label_kld:
            raise NotImplementedError("label-histogram KLD is not ported yet "
                                      "(ROADMAP M5b, use_label_kld)")
        self.fed_round += 1
        if self.fed_round <= self.cfg.warmup_fed_rounds:
            for net in ("G", "D"):
                wrapped = {g.name: {net: self.state[net]["client"][g.name]}
                           for g in self.groups}
                out = fedavg_uniform(self.groups, wrapped, self.sizes,
                                     n_layers={net: N_LAYERS[net]},
                                     use_kernel=self.cfg.use_kernel,
                                     plan_cache=self._fed_plans)
                self.state[net]["client"] = {g.name: out[g.name][net]
                                             for g in self.groups}
            diag = {"round": self.fed_round, "mode": "fedavg"}
        else:
            diag = self._federate_clustered(init_centers)
        self.fed_log.append(diag)
        return diag

    def _federate_clustered(self, init_centers) -> Dict[str, Any]:
        if not self._ema_init:
            raise RuntimeError("federate() before any training step: the "
                               "middle-activation EMA is empty")
        acts = self._mid_ema
        labels, k_sel, sil = cluster_activations(
            acts, k=self.cfg.num_clusters, use_kernel=self.cfg.use_kernel,
            gen=self._cluster_gen, init_centers=init_centers)
        bound = k_selection_bound(len(self.clients), self.cfg.num_clusters)
        weights, klds = kld_mod.activation_weights(
            acts, self._sizes_dev, labels, bound, self.cfg.beta)
        for net in ("G", "D"):
            wrapped = {g.name: {net: self.state[net]["client"][g.name]}
                       for g in self.groups}
            out = federate_client_params_device(
                self.groups, wrapped, weights, labels, bound,
                n_layers={net: N_LAYERS[net]},
                use_kernel=self.cfg.use_kernel, plan_cache=self._fed_plans)
            self.state[net]["client"] = {g.name: out[g.name][net]
                                         for g in self.groups}
        return {"round": self.fed_round, "mode": "clustered", "k": k_sel,
                "silhouette": sil, "labels": labels, "weights": weights,
                "klds": klds}

    def reoptimize_cuts(self, *args, **kwargs):
        raise NotImplementedError("online re-cut is not ported yet (ROADMAP "
                                  "M9b)")

    apply_churn = update_profile = reoptimize_cuts

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
