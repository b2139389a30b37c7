"""The driver of every mix of kind ``train``
(``portbench/traffic/<mix>.json``: ``steps_before_judged_round``,
``trace_epochs``): set-up, the measured window, and the numbers that
decide ``correct``.

Set-up builds one trainer (``program.build_trainer``) over client
datasets made from the seed (``scenario``), puts the seed's weights in
it (``weights``), and drives it through its first three steps through
the window's own call (``train_steps(1)``), reading what the comparison
needs as it goes: each step's losses, the first gradient from Adam's
state after step 1, every leaf's change after the third step, the
middle-activation EMA. It then runs the configuration's FedAvg warm-up
rounds, ``steps_before_judged_round`` steps, one KLD-clustered round
(judged: copied to the host before and after, its k-means generator's
state read before), and one whole epoch, so that the window's epochs
find every graph captured and every plan built.

The window calls ``train_epoch()`` until ``--seconds`` have passed; the
rounds run inside it at the trainer's own cadence. The benchmark's spans
wrap the trainer's ``train_steps`` and ``federate``; in a traced run
they synchronise the card around each call, and the profiler records
the window's first ``trace_epochs`` epochs.

What is compared (``Cell.numbers``), after the window, against the plain
reference (``portbench.reference``):

* the three checked steps: the first step's D loss (a function of the
  seed's weights and the batch alone), every step's two losses; the
  norm of every leaf's first gradient as Adam got it (its first moment
  after one step over ``1 - b1``), D's leaves (from the weights and the
  batch alone) and G's (taken against the updated D) apart; the norm
  of every leaf's change after the three steps; the middle-activation
  EMA the rounds cluster. A leaf is one parameter of one layer, all its
  owners' copies together (client side) or the server's copy. Norms
  are compared by the worst leaf (``check.worst_norm_gap``); a leaf
  whose reference gradient is under a thousandth of the median leaf's
  (a bias before BatchNorm, whose gradient is nought to rounding) is
  left out of both.
* the judged round, from the program's state before it (its middle
  activations and client copies; there the reference follows the
  program): the reference's own k-means (``reference.kmeans``, its
  seeds drawn from a generator in the state the program's started
  from) against the program's clustering: the number of clusters, the
  share of client pairs put together by one and apart by the other,
  and the within-cluster cost of the program's labels against the
  reference's; the program's KLD weights against Eq. 13-15 with the
  reference's labels; every aggregated client leaf against Eq. 16 of
  the pre-round copies (worst leaf); every copy the round must not
  touch (non-members, and the server's layers) bit for bit.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List, Optional

import torch

from portbench import check, program, scenario, trace as trace_mod
from portbench.reference import cgan, federation, kmeans
from portbench.reference.cgan import layer_specs, leaf_shapes
from portbench.weights import make_weights


CHECKED_STEPS = 3
WARM_EPOCHS = 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _norm(x: torch.Tensor, y: Optional[torch.Tensor] = None,
          chunk: int = 1 << 23) -> float:
    """‖x‖ (or ‖x - y‖) in float64, a few million elements at a time."""
    a = x.reshape(-1)
    b = None if y is None else y.reshape(-1)
    total = 0.0
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk] if b is None else a[i:i + chunk] - b[i:i + chunk]
        total += float(d.double().square().sum())
    return total ** 0.5


class Cell:
    """One run of a training cell: ``setup()``, ``window(seconds)``,
    ``close()``, then ``judge()``; ``context()`` for the metric
    readers."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 trace: bool = False):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        self.device = torch.device(device)
        self.trace = trace
        self.model = cfg["model"]
        self.K = cfg["clients"]
        self.paths = {net: [list(leaf_shapes(self.model, s))
                            for s in layer_specs(self.model, net)]
                      for net in ("G", "D")}
        self.spans: List[dict] = []
        self.rounds: List[dict] = []
        self.prog: Dict = {}
        self.trace_summary: Optional[dict] = None
        self._profiling = False

    # -- set-up ---------------------------------------------------------------
    def _phase(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    def setup(self) -> None:
        cfg, dev = self.cfg, self.device
        self.phases, self._t = {}, time.perf_counter()
        clients = scenario.build(cfg["scenario"], self.K, cfg["base_size"],
                                 self.model["img"], self.seed, dev)
        self._phase("data")
        self.tr = tr = program.build_trainer(cfg, clients, self.seed, dev)
        self.cuts = program.cuts(tr)
        self.phases["cuts"] = sorted({str(c) for c in self.cuts})
        self.sizes = torch.tensor([len(c[2]) for c in clients],
                                  dtype=torch.float64)
        self._phase("trainer")
        program.load_weights(tr, make_weights(self.model, self.K, self.seed,
                                              dev), self.paths)
        self._phase("weights")
        self._wrap()
        self.gen_states, losses = [], []
        for i in range(CHECKED_STEPS):
            self.gen_states.append(program.rng_state(tr))
            losses.append(tr.train_steps(1))
            if i == 0:
                b1 = self.model["adam_b1"]
                self.prog["grad_norms"] = {
                    (net,) + k: v / (1 - b1) for net in ("G", "D")
                    for k, v in program.leaf_norms(tr, net, "mu").items()}
        self.prog["losses"] = [(m["loss_d"], m["loss_g"]) for m in losses]
        self._phase("checked_steps")
        self._theta = {net: (program.host_copy(tr, net),
                             program.server_leaves(tr, net, host=True))
                       for net in ("G", "D")}
        self.prog["ema"] = program.middle_activations(tr).clone()
        self._phase("snapshot")
        for _ in range(cfg["warmup_fed_rounds"]):
            tr.federate()
        # the FedAvg rounds leave every copy of a layer alike: clients
        # train apart before the round that is judged
        for _ in range(self.mix["steps_before_judged_round"]):
            tr.train_steps(1)
        self._phase("fedavg_rounds")
        self._judged_round()
        self._phase("judged_round")
        for _ in range(WARM_EPOCHS):
            tr.train_epoch()
        self._phase("warm_epochs")
        self.steps_per_epoch = program.steps_per_epoch(tr)
        self.spans.clear()
        self.rounds.clear()

    def _change_norms(self) -> Dict:
        """‖θ - θ0‖ of every leaf after the checked steps, θ (copied to
        the host then) against the seed's weights made again."""
        W = make_weights(self.model, self.K, self.seed, self.device)
        out = {}
        for i, net in enumerate(("G", "D")):
            topo = cgan.topology(self.model, net, [c[i] for c in self.cuts],
                                 self.device)
            client, server = self._theta[net]
            client = program.join(client, self.device)
            for side, leaves in (("client", client), ("server", server)):
                for (l, path), x in leaves.items():
                    w0 = W[(net, l, side, path)]
                    if side == "client":
                        w0 = w0.index_select(0, topo[l][0])
                    out[(net, l, side, path)] = _norm(x.to(self.device), w0)
        return out

    def _judged_round(self) -> None:
        tr = self.tr
        before = {net: program.host_copy(tr, net) for net in ("G", "D")}
        server = {net: program.server_leaves(tr, net, host=True)
                  for net in ("G", "D")}
        acts = program.middle_activations(tr).clone()
        gen_state = program.cluster_rng_state(tr)
        diag = tr.federate()
        K = self.K
        cohort = torch.zeros(K, dtype=torch.bool)
        if "cohort" in diag:
            cohort[torch.as_tensor(diag["cohort"]).long().cpu()] = True
        else:
            cohort[:] = True
        self.prog["round"] = {
            "before": before, "server_before": server, "acts": acts,
            "after": {net: program.host_copy(tr, net) for net in ("G", "D")},
            "server_after": {net: program.server_leaves(tr, net, host=True)
                             for net in ("G", "D")},
            "labels": torch.as_tensor(diag["labels"]).cpu().long(),
            "weights": torch.as_tensor(diag["weights"]).cpu().double(),
            "cohort": cohort, "mode": diag["mode"], "k": diag.get("k"),
            "silhouette": diag.get("silhouette"), "gen_state": gen_state}

    # -- spans ----------------------------------------------------------------
    def _wrap(self) -> None:
        tr = self.tr
        steps, fed = tr.train_steps, tr.federate
        me = self

        def span(name, fn):
            def wrapped(*a, **k):
                if me.trace:
                    _sync(me.device)
                t0 = time.perf_counter()
                with (torch.profiler.record_function(f"portbench.{name}")
                      if me._profiling else contextlib.nullcontext()):
                    out = fn(*a, **k)
                    if me.trace:
                        _sync(me.device)
                t1 = time.perf_counter()
                rec = {"name": name, "t0": t0, "t1": t1,
                       "profiled": me._profiling}
                if name == "train_steps":
                    rec["steps"] = a[0] if a else k["n_steps"]
                    rec["finite"] = all(math.isfinite(v)
                                        for v in out.values())
                else:
                    rec["mode"] = out.get("mode")
                    rec["cohort"] = (
                        torch.as_tensor(out["cohort"]).cpu().tolist()
                        if "cohort" in out else list(range(me.K)))
                    rec["labels"] = (torch.as_tensor(out["labels"]).cpu()
                                     .tolist() if "labels" in out
                                     else [0] * me.K)
                    me.rounds.append(rec)
                me.spans.append(rec)
                return out
            return wrapped

        tr.train_steps = span("train_steps", steps)
        tr.federate = span("federate", fed)

    # -- the window -------------------------------------------------------------
    def window(self, seconds: float) -> dict:
        tr, dev = self.tr, self.device
        prof = None
        n_trace = self.mix["trace_epochs"] if self.trace else 0
        marker = None
        epochs = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            if epochs == 0 and n_trace:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                self._profiling = True
                marker = torch.profiler.record_function("portbench.window")
                marker.__enter__()
            tr.train_epoch()
            epochs += 1
            if self._profiling and (epochs >= n_trace
                                    or time.perf_counter() >= deadline):
                _sync(dev)
                marker.__exit__(None, None, None)
                self._profiling = False
                prof.__exit__(None, None, None)
            if time.perf_counter() >= deadline:
                break
        _sync(dev)
        t1 = time.perf_counter()
        steps = epochs * self.steps_per_epoch
        failed = sum(s["steps"] for s in self.spans
                     if s["name"] == "train_steps" and not s["finite"])
        self.win = {"seconds": t1 - t0, "epochs": epochs, "attempted": steps,
                    "failed": failed,
                    "samples": steps * self.K * self.cfg["batch"]}
        if prof is not None:
            dev_ev, host_ev = trace_mod.read_events(prof)
            mark = [h for h in host_ev if h[0] == "portbench.window"]
            a, b = mark[0][1], mark[0][2]
            self.trace_summary = trace_mod.summarize(dev_ev, host_ev, a, b)
        return self.win

    # -- after the window ---------------------------------------------------
    def close(self) -> dict:
        """Read the program's counters and the checked steps' batches,
        then free the program's state."""
        tr = self.tr
        self.counters = {"graph_pool_bytes": program.graph_pool_bytes(tr),
                         "steps_per_epoch": self.steps_per_epoch}
        self.batches = [program.batch_at(tr, s) for s in self.gen_states]
        del tr.train_steps, tr.federate
        self.tr = tr = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        if self.device.type == "cuda":
            self.phases["held_after_close_gib"] = (
                torch.cuda.memory_allocated(self.device) / 2 ** 30)
        self.prog["change_norms"] = self._change_norms()
        del self._theta
        r = self.prog["round"]
        for key in ("before", "after"):
            r[key] = {net: program.join(r[key][net]) for net in ("G", "D")}
        return self.counters

    # -- the reference ----------------------------------------------------------
    def reference_run(self, mode: str = "fp32", half_batch: bool = False
                      ) -> dict:
        """The reference over the checked steps' batches from the seed's
        weights: losses, first-step gradient norms, change norms and EMA
        (the same readings as ``self.prog``). ``mode="tf32"`` is the
        control; ``half_batch`` plants the fault of a loss averaged over
        half of every client's rows."""
        dev = self.device
        W = make_weights(self.model, self.K, self.seed, dev)
        topo = {net: cgan.topology(self.model, net,
                                   [c[i] for c in self.cuts], dev)
                for i, net in enumerate(("G", "D"))}
        leaves = {}
        for net in ("G", "D"):
            L = {}
            for l in range(len(layer_specs(self.model, net))):
                own, use = topo[net][l]
                for path in self.paths[net][l]:
                    if own.numel():
                        L[(l, "client", path)] = W[(net, l, "client", path)
                                                   ].index_select(0, own)
                    if use.numel():
                        L[(l, "server", path)] = W[(net, l, "server", path)]
            leaves[net] = L
        del W
        ref = cgan.SplitGAN(self.model, leaves["G"], leaves["D"], topo["G"],
                            topo["D"], self.K)
        init = {net: {k: v.clone() for k, v in leaves[net].items()}
                for net in ("G", "D")}
        del leaves
        out = {"losses": []}
        bce = cgan.bce
        if half_batch:
            cgan.bce = lambda x, t: bce(x[:, : max(1, x.shape[1] // 2)], t)
        try:
            with cgan.precision(mode):
                for i, batch in enumerate(self.batches):
                    ld, lg, gd, gg = ref.step(batch)
                    out["losses"].append((float(ld), float(lg)))
                    if i == 0:
                        out["grad_norms"] = {
                            **{("D",) + k: _norm(v) for k, v in gd.items()},
                            **{("G",) + k: _norm(v) for k, v in gg.items()}}
                    del gd, gg
        finally:
            cgan.bce = bce
        out["change_norms"] = {
            (net,) + k: _norm(v, init[net][k])
            for net, now in (("G", ref.G), ("D", ref.D))
            for k, v in now.items()}
        out["ema"] = ref.ema.detach().cpu()
        return out

    def clustering(self) -> dict:
        """The reference's k-means over the judged round's activations,
        its seeds drawn from a generator in the state the program's
        started from (computed once)."""
        if getattr(self, "_clustering", None) is None:
            r = self.prog["round"]
            gen = torch.Generator(device=self.device)
            gen.set_state(r["gen_state"])
            c = self.cfg["clustering"]
            labels, k, sil, sils = kmeans.cluster(
                r["acts"].to(self.device), gen, c["k_max"],
                c["min_silhouette"], c["iters"])
            self._clustering = {"labels": labels.cpu(), "k": k,
                                "silhouette": sil, "silhouettes": sils}
        return self._clustering

    def round_reference(self, mode: str = "fp64", uniform: bool = False,
                        all_owners: bool = False) -> dict:
        """Eq. 13-16 over the judged round's inputs with the reference's
        clustering: its labels, k, weights and aggregated client leaves.
        ``mode="tf32"`` is the control (float32, TF32 products);
        ``uniform`` plants the fault of cluster averages that ignore the
        KLD weights, ``all_owners`` the fault of a round that writes its
        averages into every copy of a cluster, in the cohort or not."""
        r = self.prog["round"]
        dev = self.device
        cl = self.clustering()
        labels = cl["labels"].to(dev)
        w, _ = federation.kld_weights(
            r["acts"].to(dev), self.sizes.to(dev), labels,
            r["cohort"].to(dev), self.model["kld_beta"])
        if uniform:
            w = r["cohort"].to(dev).double()
        after = {}
        for i, net in enumerate(("G", "D")):
            topo = cgan.topology(self.model, net, [c[i] for c in self.cuts],
                                 dev)
            owners = {l: topo[l][0] for l in range(len(topo))}
            before = {k: v.to(dev) for k, v in r["before"][net].items()}
            agg = federation.aggregate(
                before, owners, labels, r["cohort"].to(dev), w,
                tf32=mode == "tf32", write_all=all_owners)
            after[net] = {k: v.cpu() for k, v in agg.items()}
        return {"weights": w.cpu(), "after": after, "labels": cl["labels"],
                "k": cl["k"]}

    def numbers(self, cand: dict, ref: dict, round_cand: dict,
                round_ref: dict) -> Dict[str, float]:
        """The numbers compared with their limits: ``cand`` (the
        program's readings, or the control's) against ``ref``."""
        losses = max(check.rel_gap(a, b)
                     for pa, pb in zip(cand["losses"], ref["losses"])
                     for a, b in zip(pa, pb))
        keys = list(ref["grad_norms"])
        gn = ref["grad_norms"]

        def grad_gap(net):
            ks = [k for k in keys if k[0] == net]
            return check.worst_norm_gap(cand["grad_norms"], gn, gn, ks)

        ema = float((cand["ema"].double() - ref["ema"].double()).norm()
                    / ref["ema"].double().norm())
        out = {"loss_d1_gap": check.rel_gap(cand["losses"][0][0],
                                            ref["losses"][0][0]),
               "loss_gap": losses,
               "grad_d_gap": grad_gap("D"), "grad_g_gap": grad_gap("G"),
               "change_gap": check.worst_norm_gap(
                   cand["change_norms"], ref["change_norms"], gn, keys),
               "ema_gap": ema}
        acts = self.prog["round"]["acts"].to(self.device)
        ref_cost = kmeans.cost(acts, round_ref["labels"])
        out["round_k_gap"] = float(abs(round_cand["k"] - round_ref["k"]))
        out["round_pair_gap"] = kmeans.pair_gap(round_cand["labels"],
                                                round_ref["labels"])
        out["round_cost_gap"] = abs(kmeans.cost(acts, round_cand["labels"])
                                    - ref_cost) / max(ref_cost, 1e-30)
        out["round_weight_gap"] = float(
            (round_cand["weights"].double()
             - round_ref["weights"].double()).abs().max())
        out["round_theta_gap"] = max(
            check.leaf_diff_gap(round_cand["after"][net],
                                round_ref["after"][net])
            for net in ("G", "D"))
        out["round_untouched_changed"] = float(self._untouched(round_cand))
        return out

    def _untouched(self, cand: dict) -> int:
        """Elements the round must leave bit for bit that changed: every
        copy of a client outside the cohort, and the server's layers."""
        r = self.prog["round"]
        n = 0
        for i, net in enumerate(("G", "D")):
            topo = cgan.topology(self.model, net, [c[i] for c in self.cuts],
                                 "cpu")
            for (l, path), after in cand["after"][net].items():
                keep = ~r["cohort"][topo[l][0]]
                n += int((after[keep] != r["before"][net][(l, path)][keep])
                         .sum())
            for k, v in r["server_after"][net].items():
                n += int((v != r["server_before"][net][k]).sum())
        return n

    def program_round(self) -> dict:
        r = self.prog["round"]
        return {"weights": r["weights"], "after": r["after"],
                "labels": r["labels"], "k": r["k"]}

    def judge(self) -> Dict[str, float]:
        """The program's numbers against the reference (after
        ``close()``)."""
        return self.numbers(self.prog, self.reference_run("fp32"),
                            self.program_round(), self.round_reference())

    def context(self) -> dict:
        """What the metric readers read beside the window's numbers."""
        return {"spans": self.spans, "rounds": self.rounds,
                "counters": self.counters, "cuts": self.cuts,
                "clients": self.K, "batch": self.cfg["batch"]}


def readings(run: Cell, half_batch: bool = True) -> dict:
    """The readings the limits are set from, after ``run.close()``
    (``portbench.calibrate``): the program's numbers, the control's (the
    reference in the precision below the configuration's: TF32 products;
    for the round, float32 with TF32-rounded operands) and those of the
    faults planted in the reference or in what it judges:

    * ``half_batch``: every loss averaged over half of each client's rows
      (``half_batch=False`` leaves it out);
    * ``round_uniform``: cluster averages that ignore the KLD weights;
    * ``round_skipped``: a round that leaves every copy as it was;
    * ``round_all_owners``: a round that writes its averages into the
      copies of clients outside the cohort too;
    * ``labels_swapped``: two clients of different clusters trade labels
      where the clustering produces them.

    A step that leaves the state unchanged reads 1 in ``change_gap`` by
    the comparison's own measure and needs no run. Faults planted in the
    program (``program.plant``) are read as its numbers in a run of
    their own."""
    t0 = time.perf_counter()
    ref = run.reference_run("fp32")
    t_ref = time.perf_counter() - t0
    rref = run.round_reference("fp64")
    t_round = time.perf_counter() - t0 - t_ref
    ctl = run.reference_run("tf32")
    rctl = run.round_reference("tf32")
    runi = run.round_reference("fp64", uniform=True)
    prog_round = run.program_round()
    skipped = {**prog_round, "after": run.prog["round"]["before"]}
    rall = run.round_reference("fp64", all_owners=True)
    lab = prog_round["labels"].clone()
    other = (lab != lab[0]).nonzero().flatten()
    if other.numel():
        lab[0], lab[other[0]] = lab[other[0]].clone(), lab[0].clone()
    out = {}
    if half_batch:
        half = run.reference_run("fp32", half_batch=True)
        out["half_batch"] = run.numbers(half, ref, prog_round, rref)
    cl = run.clustering()
    return {
        **out,
        "program": run.numbers(run.prog, ref, prog_round, rref),
        "control": run.numbers(ctl, ref, rctl, rref),
        "round_uniform": run.numbers(run.prog, ref, runi, rref),
        "round_skipped": run.numbers(run.prog, ref, skipped, rref),
        "round_all_owners": run.numbers(run.prog, ref, rall, rref),
        "labels_swapped": run.numbers(run.prog, ref,
                                      {**prog_round, "labels": lab}, rref),
        "k": prog_round["k"], "ref_k": cl["k"],
        "silhouette": run.prog["round"]["silhouette"],
        "ref_silhouettes": cl["silhouettes"],
        "reference_s": t_ref, "round_reference_s": t_round}
