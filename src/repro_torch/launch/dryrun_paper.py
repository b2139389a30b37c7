"""Paper-technique dry run: trace the HuSCF split-federated training
steps on the production mesh (port of ``repro.launch.dryrun_paper``).

Two subjects:
  * huscf-gan       — the paper's cGAN with 224 clients over the paper's
                      7 device profiles (32 each), 4 cuts each
                      (GA-assigned), the client population sharded over
                      the data axes.
  * huscf-lm:<arch> — the §7.3 extension: the 2-cut U-shaped split of an
                      LM with per-profile client stacks.

The GAN step is the trainer's own (``core.huscf.gan_train_step``, the
client-sharded step): this process is rank 0 of the fake group (see
``launch.dryrun``) and holds its block of every group's rows
(``policy.row_block`` over the mesh's data axes), on meta tensors. Its
executors sum the server's BatchNorm statistics over the ranks
(``launch.mesh.reduce_sum``), each net's server gradients go through one
``all_reduce_flat``, and the update runs in place, as the trainer's fused
epoch runs it. No DTensor is pushed through the grouped convolutions:
DTensor has no rule for a client axis folded into a convolution's
channels and would gather the whole population onto every rank. Where
the data axes do not divide every group (the 2-pod mesh: 64 ranks,
groups of 32) every rank runs every row, as the trainer's replicated
step does, with no collective per step; the record says so under
``variant`` ("+replicated").

The split LM runs ``split_transformer.make_split_train_step`` on
DTensors: the server trunk under the LM's rules, the client stacks over
the data axes, their embedding tables ``[K, V, D]`` also over ``model``.

Nothing happens at import; run it in a process of its own:
``python -m repro_torch.launch.dryrun_paper --lm granite-3-2b --device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.core import split_transformer as ST
from repro_torch.core.genetic import GAConfig, optimize_cuts
from repro_torch.core.huscf import (build_net_apply, gan_train_step,
                                    make_epoch_fn)
from repro_torch.core.latency import PAPER_DEVICES, PAPER_SERVER
from repro_torch.core.splitting import group_by_profile, server_union_span
from repro_torch.data.pipeline import (DeviceDataset, sample_batch,
                                       step_client_axes)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.dryrun import (Lowered, _dpa, _to_dtensors, analyze,
                                       meta_struct, n_ranks, production_mesh,
                                       stop_fake_group)
from repro_torch.models.gan import (DISC_LAYER_DEFS, DISC_MIDDLE_FEATURES,
                                    GEN_LAYER_DEFS, NUM_CLASSES, Z_DIM)
from repro_torch.optim.optimizers import AdamState, adam
from repro_torch.sharding.policy import (ShardingPolicy, data_axes, row_block,
                                         sanitize, tree_param_specs)
from repro_torch.tree import tree_map

GAN_LR, GAN_B1 = 2e-4, 0.5        # HuSCFConfig's


def build_gan_population(n_clients: int = 224, batch: int = 64,
                         device: str = "cuda"):
    """GA-assigned cuts for the client population over the paper's 7
    profiles. Clients are laid out profile-contiguously with equal
    per-profile counts (a multiple of 32), so every group's rows split
    evenly over a 32-way data axis; a group the data axes do not divide
    runs replicated on every rank."""
    per = max(32, n_clients // 7 // 32 * 32)
    devices = [PAPER_DEVICES[p] for p in range(7) for _ in range(per)]
    res = optimize_cuts(devices, PAPER_SERVER, batch=batch,
                        config=GAConfig(population_size=60, generations=10,
                                        seed=0), device=device)
    return group_by_profile(devices, res.cuts), res


def step_layout(groups, mesh):
    """(the mesh axes the step's rows shard over or None, this rank's
    groups: each holding its block of the group's rows)."""
    axes = step_client_axes(groups, mesh)
    return axes, [dataclasses.replace(
        g, client_ids=g.client_ids[slice(*row_block(mesh, g.size, axes))])
        for g in groups]


def gan_state_struct(groups, local_groups=None):
    """Meta tensors of a rank's trainer state (``HuSCFTrainer._init_state``):
    the client stacks of ``local_groups``' rows (default ``groups``), the
    server layers of the union span, Adam's moments and device step."""
    local = {g.name: g for g in (local_groups or groups)}

    def init():
        gen = torch.Generator()
        params = {}
        for net, defs in (("G", GEN_LAYER_DEFS), ("D", DISC_LAYER_DEFS)):
            n = len(defs)
            server = {str(l): tree_map(lambda t: t[0],
                                       defs[l].init(1, gen, "cpu"))
                      for l in server_union_span(groups, net, n)}
            client = {}
            for g in groups:
                h, t = ((g.cut.g_h, g.cut.g_t) if net == "G"
                        else (g.cut.d_h, g.cut.d_t))
                client[g.name] = {
                    str(l): defs[l].init(local[g.name].size, gen, "cpu")
                    for l in list(range(h)) + list(range(t, n))}
            params[net] = {"client": client, "server": server}
        opt_init, _ = adam(GAN_LR, b1=GAN_B1)

        def opt(p):
            return opt_init(p)._replace(step=torch.zeros((),
                                                         dtype=torch.int32))
        return {"G": params["G"], "D": params["D"],
                "opt_g": opt(params["G"]), "opt_d": opt(params["D"]),
                "step": 0}
    return meta_struct(init)


def build_gan_step(groups, batch: int, concat_groups: bool = True,
                   return_mids: bool = False, mesh=None):
    """One HuSCF-GAN train step as the trainer runs it
    (``gan_train_step``, in place), for this rank's rows on ``mesh``
    (every row without a mesh). ``concat_groups=False`` is the no-concat
    server schedule; ``return_mids`` also returns the per-group middle
    activation batch means."""
    axes, local = step_layout(groups, mesh) if mesh is not None else \
        (None, list(groups))
    reduce = (None if axes is None else
              lambda x: mesh_mod.reduce_sum(x, mesh, axes))
    gen_apply = build_net_apply(local, "G", concat_groups=concat_groups,
                                reduce=reduce)
    disc_apply = build_net_apply(local, "D", capture_middle=True,
                                 concat_groups=concat_groups, reduce=reduce)
    _, opt_update = adam(GAN_LR, b1=GAN_B1)
    total = sum(g.size for g in groups)

    def step(state, batch_in):
        st, metrics, mids = gan_train_step(
            state, batch_in, step_groups=local, total_clients=total,
            gen_apply=gen_apply, disc_apply=disc_apply,
            opt_update=opt_update, mesh=mesh, axes=axes, inplace=True)
        return (st, metrics, mids) if return_mids else (st, metrics)

    return step


def build_gan_epoch(groups, batch: int, n_steps: int,
                    concat_groups: bool = True, mesh=None,
                    dataset: Optional[DeviceDataset] = None):
    """The fused device-resident epoch on dry-run structs: per-step
    on-device sampling from a staged ``DeviceDataset`` plus the in-carry
    middle-activation EMA, ``n_steps`` steps run eagerly (no CUDA graph
    is captured on meta tensors). The epoch is the trainer's
    ``huscf.make_epoch_fn``. Returns ``epoch(state, gen, ema, ema_init,
    losses)``."""
    axes, local = step_layout(groups, mesh) if mesh is not None else \
        (None, list(groups))
    step = build_gan_step(groups, batch, concat_groups=concat_groups,
                          return_mids=True, mesh=mesh)
    ds = dataset if dataset is not None else gan_dataset_struct(groups,
                                                                mesh=mesh)
    rows, off = {}, 0
    for g in local:
        rows[g.name] = torch.arange(off, off + g.size, device="meta")
        off += g.size
    if axes is None:
        rows = {g.name: torch.as_tensor(g.client_ids, device="meta")
                for g in groups}
    return make_epoch_fn(
        local, lambda st, b: step(st, b)[1:],
        lambda gen: sample_batch(ds, gen, batch=batch, z_dim=Z_DIM,
                                 num_classes=NUM_CLASSES),
        n_steps, rows=rows)


def gan_dataset_struct(groups, n_rows: int = 600, mesh=None) -> DeviceDataset:
    """A meta ``DeviceDataset`` (padded client rows): this rank's block of
    each group's rows, every row's count."""
    blocks = {g.name: (0, g.size) if mesh is None else
              row_block(mesh, g.size, step_client_axes(groups, mesh))
              for g in groups}

    def rows(g):
        lo, hi = blocks[g.name]
        return hi - lo
    images = {g.name: torch.empty((rows(g), n_rows, 28, 28, 1),
                                  device="meta") for g in groups}
    labels = {g.name: torch.empty((rows(g), n_rows), dtype=torch.int32,
                                  device="meta") for g in groups}
    counts = {g.name: torch.empty((g.size,), dtype=torch.int32,
                                  device="meta") for g in groups}
    return DeviceDataset(tuple(g.name for g in groups), images, labels,
                         counts, blocks)


def gan_batch_struct(groups, batch, act_dtype=torch.float32):
    """A meta training batch for ``groups``' rows, in the trainer's keys
    (``real_img``, ``real_y``, ``z``, ``fake_y``; the reference's
    ``img``, ``y``, ``z``, ``fy``)."""
    out = {"real_img": {}, "real_y": {}, "z": {}, "fake_y": {}}
    for g in groups:
        k = g.size
        out["real_img"][g.name] = torch.empty((k, batch, 28, 28, 1),
                                              dtype=act_dtype, device="meta")
        out["real_y"][g.name] = torch.empty((k, batch), dtype=torch.int32,
                                            device="meta")
        out["z"][g.name] = torch.empty((k, batch, Z_DIM), dtype=act_dtype,
                                       device="meta")
        out["fake_y"][g.name] = torch.empty((k, batch), dtype=torch.int32,
                                            device="meta")
    return out


def run_gan(multi_pod: bool, n_clients: int = 224, batch: int = 64,
            concat_groups: bool = True, bf16_acts: bool = False,
            scan_steps: int = 0, *, device: str = "cuda", mesh=None,
            groups: Optional[Sequence] = None, ga_latency=None
            ) -> Dict[str, Any]:
    """scan_steps > 0 traces the fused device-resident epoch (on-device
    sampling + EMA carry) instead of one training step. ``groups`` (with
    ``ga_latency``) skip the cut search; ``mesh`` None is the production
    mesh."""
    if scan_steps > 0 and bf16_acts:
        # the epoch samples its batches on device (f32, trainer
        # parity); a silent f32 trace must not masquerade as bf16
        raise ValueError("--bf16 is not supported with --scan-steps: "
                         "the device-resident epoch stages/samples f32")
    if mesh is None:
        mesh = production_mesh(multi_pod, device)
    if groups is None:
        groups, ga = build_gan_population(n_clients, batch, device=device)
        ga_latency = ga.latency
    axes, local = step_layout(groups, mesh)
    state = gan_state_struct(groups, local)
    if scan_steps > 0:
        ds = gan_dataset_struct(groups, mesh=mesh)
        epoch = build_gan_epoch(groups, batch, scan_steps,
                                concat_groups=concat_groups, mesh=mesh,
                                dataset=ds)
        k = sum(g.size for g in local)
        ema = torch.empty((k, DISC_MIDDLE_FEATURES), device="meta")
        ema_init = torch.empty((), dtype=torch.bool, device="meta")
        losses = {n: torch.empty((), device="meta")
                  for n in ("loss_d", "loss_g")}
        # meta draws need no generator; the staged dataset is an
        # argument, as in the reference
        lowered = Lowered(lambda st, e, e0, ls, _ds: epoch(st, None, e, e0,
                                                           ls),
                          (state, ema, ema_init, losses, ds), mesh,
                          ShardingPolicy())
        shape_name = f"epoch{scan_steps}_b{batch}_K{n_clients}"
    else:
        step = build_gan_step(groups, batch, concat_groups=concat_groups,
                              mesh=mesh)
        batch_in = gan_batch_struct(
            local, batch, torch.bfloat16 if bf16_acts else torch.float32)
        lowered = Lowered(step, (state, batch_in), mesh, ShardingPolicy())
        shape_name = f"train_b{batch}_K{n_clients}"
    replicated = axes is None and n_ranks(mesh) > 1
    meta = {"arch": "huscf-gan", "shape": shape_name,
            "multi_pod": multi_pod, "kind": "paper-train",
            "chips": n_ranks(mesh), "params": 3_018_182,
            "ga_latency_model_s": ga_latency,
            "variant": ("paper-concat" if concat_groups else "no-concat")
            + ("+bf16" if bf16_acts else "")
            + ("+replicated" if replicated else ""),
            "rows_per_rank": sum(g.size for g in local)}
    return analyze(lowered, meta)


class RankRows:
    """A client population laid out over a mesh's data axes (its stacks
    DTensors sharded on the client dim along them, as ``run_lm`` lays the
    reference's specs out), for ``split_transformer``'s ``rows``: each
    rank runs its own clients, as the reference's ``vmap`` over a sharded
    client axis does, where the port's loop over the clients would
    gather the whole population onto every rank. ``local`` turns a tree
    of such stacks into this rank's rows, DTensors over the mesh's other
    axes; ``to_mesh`` makes the
    rows of this rank's clients its block of a batch over the whole mesh
    (the trunk runs row by row, so which rows form a rank's block is a
    relabelling of the reference's concatenation); ``from_mesh`` is its
    inverse, and ``sum_over_ranks`` sums a per-rank scalar over the data
    axes."""

    def __init__(self, mesh):
        from torch.distributed.tensor import Replicate
        self.mesh = mesh
        self.data = set(data_axes(mesh))
        names = mesh.mesh_dim_names
        self.rest = tuple(i for i, n in enumerate(names)
                          if n not in self.data)
        self.sub = (mesh[tuple(names[i] for i in self.rest)]
                    if self.rest else None)
        self.rep = Replicate()

    @staticmethod
    def of(tree) -> "RankRows | None":
        from torch.distributed.tensor import DTensor, Shard
        leaf = ST._first_leaf(tree)
        if not isinstance(leaf, DTensor):
            return None
        names = leaf.device_mesh.mesh_dim_names
        data = set(data_axes(leaf.device_mesh))
        if not data or any(n in data and p != Shard(0)
                           for n, p in zip(names, leaf.placements)):
            return None
        return RankRows(leaf.device_mesh)

    def _on_sub(self, local, placements):
        from torch.distributed.tensor import DTensor
        if self.sub is None:
            return local
        return DTensor.from_local(local, self.sub,
                                  [placements[i] for i in self.rest],
                                  run_check=False)

    def local(self, tree):
        return tree_map(lambda x: self._on_sub(x.to_local(), x.placements),
                        tree)

    def to_mesh(self, x):
        from torch.distributed.tensor import DTensor, Shard
        sub = list(x.placements) if self.sub is not None else []
        local = x.to_local() if self.sub is not None else x
        places = []
        for i, n in enumerate(self.mesh.mesh_dim_names):
            places.append(Shard(0) if n in self.data else sub.pop(0))
        return DTensor.from_local(local, self.mesh, places, run_check=False)

    def from_mesh(self, x):
        return self._on_sub(x.to_local(), x.placements)

    def sum_over_ranks(self, v):
        from torch.distributed.tensor import DTensor, Partial
        local = v.to_local() if self.sub is not None else v
        places = [Partial() if n in self.data else self.rep
                  for n in self.mesh.mesh_dim_names]
        s = DTensor.from_local(local, self.mesh, places, run_check=False)
        return s.redistribute(self.mesh, [self.rep] * len(places))


def split_lm_specs(mesh, policy: ShardingPolicy, params) -> Dict[str, Any]:
    """The split LM's specs (the reference's): the server trunk under the
    LM's TP+FSDP rules; the client stacks over the data axes, their
    embedding tables ``[K, V, D]`` also vocabulary-sharded over
    ``model``."""
    dpa = _dpa(mesh)

    def client_specs(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = client_specs(v)
            elif k == "table":      # [K, V, D]
                out[k] = sanitize(mesh, v.shape, (dpa, "model", None))
            else:
                out[k] = sanitize(mesh, v.shape,
                                  (dpa,) + (None,) * (v.ndim - 1))
        return out
    return {"server": tree_param_specs(mesh, policy, params["server"]),
            "clients": client_specs(params["clients"])}


def run_lm(arch: str, multi_pod: bool, *, seq: int = 1024,
           per_client_batch: int = 2, n_weak: int = 32, n_strong: int = 32,
           device: str = "cuda", mesh=None, cfg_override=None
           ) -> Dict[str, Any]:
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if mesh is None:
        mesh = production_mesh(multi_pod, device)
    groups = ST.default_groups(cfg, n_weak=n_weak, n_strong=n_strong)
    params = meta_struct(lambda: ST.init_split_lm(
        cfg, groups, torch.Generator(), device="cpu"))
    policy = ShardingPolicy()
    dpa = _dpa(mesh)
    specs = split_lm_specs(mesh, policy, params)
    d_params = _to_dtensors(mesh, params, specs)
    step, _ = ST.make_split_train_step(
        cfg, groups, rows=RankRows.of(d_params["clients"]))
    opt = AdamState(0, _to_dtensors(mesh, params, specs, torch.float32),
                    _to_dtensors(mesh, params, specs, torch.float32))
    tok = {g.name: torch.empty((g.n_clients, per_client_batch, seq),
                               dtype=torch.int32, device="meta")
           for g in groups}
    bspec = {g.name: sanitize(mesh, tok[g.name].shape, (dpa, None, None))
             for g in groups}
    batch = {"tokens": _to_dtensors(mesh, tok, bspec),
             "labels": _to_dtensors(mesh, tok, bspec)}
    lowered = Lowered(step, (d_params, opt, batch), mesh, policy)
    meta = {"arch": f"huscf-lm:{arch}", "shape": f"split_train_s{seq}",
            "multi_pod": multi_pod, "kind": "paper-train",
            "chips": n_ranks(mesh), "params": cfg.param_count()}
    return analyze(lowered, meta)


def _line(res: Dict[str, Any]) -> str:
    return (f"flops={res['cost'].get('flops', 0):.3e} "
            f"coll={res['collectives'].get('total', 0):.3e}B "
            f"peak={res['memory'].get('peak_bytes', 0) / 2**30:.2f}GiB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--lm", default=None,
                    help="also dry-run the split-LM for this arch")
    ap.add_argument("--skip-gan", action="store_true")
    ap.add_argument("--no-concat", action="store_true",
                    help="beyond-paper per-group server schedule")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 activations (beyond-paper)")
    ap.add_argument("--scan-steps", type=int, default=0,
                    help="trace a fused device-resident epoch of N steps "
                         "(on-device sampling + EMA carry) instead of a "
                         "single step")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type and the cut search's "
                         "device (cuda, or cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    try:
        for mp in meshes:
            pod = "2pod" if mp else "1pod"
            if not args.skip_gan:
                t0 = time.time()
                res = run_gan(mp, concat_groups=not args.no_concat,
                              bf16_acts=args.bf16,
                              scan_steps=args.scan_steps, device=args.device)
                res["wall_s"] = round(time.time() - t0, 1)
                results.append(res)
                print(f"[paper-dryrun] huscf-gan x {pod}: {_line(res)} "
                      f"({res['variant']}, {res['wall_s']}s)", flush=True)
            if args.lm:
                t0 = time.time()
                res = run_lm(args.lm, mp, device=args.device)
                res["wall_s"] = round(time.time() - t0, 1)
                results.append(res)
                print(f"[paper-dryrun] huscf-lm:{args.lm} x {pod}: "
                      f"{_line(res)} ({res['wall_s']}s)", flush=True)
    finally:
        stop_fake_group()
    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
