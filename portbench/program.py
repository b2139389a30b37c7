"""Everything the benchmark takes from the program under test, the
PyTorch port ``repro_torch``: the trainer built as its launcher builds
it, the state it trains (read to judge it, and its initial weights
replaced by the benchmark's), its sampler's draws, and its counters.
This is the only module of the benchmark that imports the program."""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

import repro_torch  # noqa: E402,F401  (a checkout without it runs nothing)

LeafKey = Tuple[int, str]            # (layer, "a.b" path)


def build_trainer(cfg: dict, clients, seed: int, device):
    """``repro_torch.core.huscf.HuSCFTrainer`` with ``HuSCFConfig`` as
    ``repro_torch.launch.train`` builds it (fused epochs, kernels K1/K2
    on, TF32 off), over the benchmark's client datasets and the
    configuration's device profiles (client i on profile i % 7), its
    cut search seeded by the configuration (the launcher's population
    and generations), so that every run trains the same cuts."""
    from repro_torch.core.genetic import GAConfig
    from repro_torch.core.huscf import HuSCFConfig, HuSCFTrainer
    from repro_torch.core.latency import DeviceProfile
    from repro_torch.data.partition import ClientSpec

    torch.backends.cuda.matmul.allow_tf32 = cfg["model"]["tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["model"]["tf32"]
    specs = [ClientSpec(i, dom, imgs, labs)
             for i, (dom, imgs, labs) in enumerate(clients)]
    profiles = [DeviceProfile(d["name"], d["freq_hz"], d["flops_per_cycle"],
                              d["rate_bytes_per_s"]) for d in cfg["devices"]]
    devices = [profiles[i % len(profiles)] for i in range(len(specs))]
    m = cfg["model"]
    conf = HuSCFConfig(batch=cfg["batch"], federate_every=cfg["federate_every"],
                       beta=m["kld_beta"], lr=m["lr"], adam_b1=m["adam_b1"],
                       seed=seed, use_kernel=True,
                       warmup_fed_rounds=cfg["warmup_fed_rounds"],
                       fused_epoch=True,
                       cohort_size=cfg["cohort"], agg_chunk=cfg["agg_chunk"])
    ga = GAConfig(population_size=cfg["ga"]["population"],
                  generations=cfg["ga"]["generations"], seed=cfg["ga"]["seed"])
    return HuSCFTrainer(specs, devices, config=conf, ga_config=ga,
                        device=device)


def cuts(tr) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Each client's ((G head, G tail), (D head, D tail)) cut, by id."""
    out = [None] * len(tr.clients)
    for g in tr.groups:
        for cid in g.client_ids:
            out[cid] = ((g.cut.g_h, g.cut.g_t), (g.cut.d_h, g.cut.d_t))
    return out


def _nest(items) -> dict:
    out: dict = {}
    for path, x in items:
        node = out
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = x
    return out


def load_weights(tr, W, model_layers: Dict[str, List[Dict[str, tuple]]]
                 ) -> None:
    """Replace the trainer's parameters with the benchmark's: each group
    takes its clients' rows of the layers it owns, the server its copy
    of the layers it runs (``HuSCFTrainer.load_whole_state``); Adam's
    moments stay at their zero start."""
    state = dict(tr.state)
    for net in ("G", "D"):
        client = {}
        for g in tr.groups:
            ids = torch.as_tensor(g.client_ids, device=tr.device)
            client[g.name] = {
                l: _nest((path, W[(net, int(l), "client", path)]
                          .index_select(0, ids).contiguous())
                         for path in model_layers[net][int(l)])
                for l in tr.state[net]["client"][g.name]}
        server = {l: _nest((path, W[(net, int(l), "server", path)].clone())
                           for path in model_layers[net][int(l)])
                  for l in tr.state[net]["server"]}
        state[net] = {"client": client, "server": server}
        old = dict(_items(tr.state[net]))
        new = dict(_items(state[net]))
        if {k: tuple(v.shape) for k, v in old.items()} != \
                {k: tuple(v.shape) for k, v in new.items()}:
            raise ValueError(f"the benchmark's {net} leaves do not match "
                             "the trainer's")
    tr.load_whole_state(state)


def host_copy(tr, net: str, tree: str = "params", host: bool = True
              ) -> Dict[LeafKey, list]:
    """Each group's rows of every client leaf, ``{(layer, path): [(client
    ids, rows)]}``, copied to the host (``join`` puts them in order)."""
    parts: Dict[LeafKey, list] = {}
    for ids, key, x in _group_leaves(tr, net, tree):
        parts.setdefault(key, []).append(
            (list(ids), x.to("cpu", copy=True) if host else x))
    return parts


def join(parts: Dict[LeafKey, list], device=None
         ) -> Dict[LeafKey, torch.Tensor]:
    """``host_copy``'s groups as one tensor per leaf, rows in ascending
    client id, on ``device`` (default: where they are)."""
    out = {}
    for key, lst in parts.items():
        ids = np.concatenate([np.asarray(i) for i, _ in lst])
        x = torch.cat([t.to(device) if device is not None else t
                       for _, t in lst], 0)
        order = torch.as_tensor(np.argsort(ids, kind="stable"),
                                device=x.device)
        out[key] = x.index_select(0, order)
    return out


def _group_leaves(tr, net: str, tree: str = "params"):
    """(the group's client ids, (layer, path), its stacked leaf) of every
    client leaf of ``net``, group by group."""
    src = (tr.state[net]["client"] if tree == "params"
           else tr.state["opt_" + net.lower()].mu["client"])
    for g in tr.groups:
        for l, layer in src[g.name].items():
            for path, x in _items(layer):
                yield g.client_ids, (int(l), path), x


def leaf_norms(tr, net: str, tree: str = "params"
               ) -> Dict[Tuple[int, str, str], float]:
    """The norm of every leaf of ``net`` (client leaves over all their
    owners' rows), ``{(layer, side, path): norm}``, from each group's
    rows in place."""
    sq: Dict[Tuple[int, str, str], float] = {}
    for _, (l, path), x in _group_leaves(tr, net, tree):
        key = (l, "client", path)
        sq[key] = sq.get(key, 0.0) + _sum_squares(x)
    for (l, path), x in server_leaves(tr, net, tree).items():
        sq[(l, "server", path)] = _sum_squares(x)
    return {k: v ** 0.5 for k, v in sq.items()}


def _sum_squares(x: torch.Tensor, chunk: int = 1 << 23) -> float:
    """Sum of squares in float64, a few million elements at a time."""
    flat = x.reshape(-1)
    return float(sum(flat[i:i + chunk].double().square().sum()
                     for i in range(0, flat.numel(), chunk)))


def server_leaves(tr, net: str, tree: str = "params", host: bool = False
                  ) -> Dict[LeafKey, torch.Tensor]:
    src = (tr.state[net]["server"] if tree == "params"
           else tr.state["opt_" + net.lower()].mu["server"])
    return {(int(l), path): x.to("cpu", copy=True) if host else x
            for l, layer in src.items() for path, x in _items(layer)}


def _items(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + k + ".")
        else:
            yield prefix + k, v


def middle_activations(tr) -> torch.Tensor:
    """The ``[K, F]`` middle-activation EMA the rounds cluster."""
    return torch.as_tensor(tr.middle_activations())


def rng_state(tr) -> torch.Tensor:
    """The state of the generator the fused epoch draws its batches
    from (read before a step, to draw that step's batch again)."""
    return tr._train_gen.get_state()


def cluster_rng_state(tr) -> torch.Tensor:
    """The state of the generator the clustered round's k-means++ draws
    its seeds from (read before the round, to draw them again)."""
    return tr._cluster_gen.get_state()


def batch_at(tr, state: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The batch the trainer's sampler draws from a generator in
    ``state``: every field ``[K, b, ...]`` by client id, images as
    ``[K, b, C, H, W]``."""
    gen = torch.Generator(device=tr.device)
    gen.set_state(state)
    b = tr._sample(gen)
    out = {}
    for field, by_group in b.items():
        ids = np.concatenate([np.asarray(g.client_ids) for g in tr.groups])
        x = torch.cat([by_group[g.name] for g in tr.groups], 0)
        order = torch.as_tensor(np.argsort(ids, kind="stable"),
                                device=x.device)
        x = x.index_select(0, order)
        if field == "real_img":
            x = x.permute(0, 1, 4, 2, 3)
        out[field] = x.contiguous()
    return out


def graph_pool_bytes(tr) -> Optional[int]:
    """``GraphPool.pool_bytes``: the device memory the fused epochs'
    CUDA graph captures reserved (None off the card)."""
    pool = getattr(tr, "_graph_pool", None)
    return None if pool is None else int(pool.pool_bytes)


def steps_per_epoch(tr) -> int:
    return tr.cfg.steps_per_epoch or max(
        1, int(np.median(tr.sizes)) // tr.cfg.batch)


FAULTS = ("state_unchanged", "half_batch", "weights_altered", "one_cluster",
          "k2_wrong")


def plant(fault: str, patch) -> None:
    """Break the timed path underneath the harness, for the calibration
    of the limits and for the tests; ``patch(obj, name, value)`` sets an
    attribute (``pytest``'s ``monkeypatch.setattr``, or ``setattr``).

    * ``state_unchanged``: every step returns the state it was given;
    * ``half_batch``: every loss averaged over half of each client's rows;
    * ``weights_altered``: the round's KLD weights in reverse client order;
    * ``one_cluster``: the round's clustering puts every client in one
      cluster;
    * ``k2_wrong``: kernel K2 assigns the first client to its second
      nearest centre.
    """
    from repro_torch.core import huscf, kld
    from repro_torch.kernels import ops
    from repro_torch.models import gan
    if fault == "state_unchanged":
        step = huscf.gan_train_step

        def update(state, grads, params, inplace=False):
            return state, params

        patch(huscf, "gan_train_step", lambda st, batch, **kw: step(
            st, batch, **{**kw, "opt_update": update}))
    elif fault == "half_batch":
        bce = gan.bce_logits
        patch(gan, "bce_logits",
              lambda x, t: bce(x[: max(1, x.shape[0] // 2)], t))
    elif fault == "weights_altered":
        weights = kld.activation_weights

        def altered(acts, sizes, labels, k, beta, cohort_mask=None):
            w, klds = weights(acts, sizes, labels, k, beta,
                              cohort_mask=cohort_mask)
            return w.flip(0), klds
        patch(kld, "activation_weights", altered)
    elif fault == "one_cluster":
        patch(huscf, "cluster_activations", lambda acts, **kw: (
            torch.zeros(acts.shape[0], dtype=torch.int32,
                        device=acts.device), 1, 0.0))
    elif fault == "k2_wrong":
        assign = ops.kmeans_assign

        def wrong(x, centers):
            labels = assign(x, centers)
            if centers.shape[0] > 1:
                d = ((x[:1] - centers) ** 2).sum(-1)
                labels[0] = torch.argsort(d)[1].to(labels.dtype)
            return labels
        patch(ops, "kmeans_assign", wrong)
    else:
        raise ValueError(f"no fault {fault!r}; faults: {FAULTS}")
