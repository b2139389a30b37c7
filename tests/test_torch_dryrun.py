"""The port's dry runs (``repro_torch.launch.input_specs``, ``dryrun``,
``dryrun_paper``) against the JAX package's.

* ``input_specs``: exact parity for every arch and input shape: skip
  reasons, decode windows, kinds, and every stand-in's path, shape and
  dtype (the port's meta tensors against the reference's
  ``ShapeDtypeStruct`` trees).
* The traced steps run in one spawned process (a process has one
  default process group; the dry run starts a fake one). The JAX
  package's ``launch.dryrun``/``dryrun_paper`` set ``XLA_FLAGS`` for 512
  host devices when imported, so this process never imports them: the
  reference's GAN step is counted in a spawned JAX process, its LM steps
  here (``repro.models.transformer``).

The reference's count is the products in ``jax.make_jaxpr`` of its step:
``dot_general`` and ``conv_general_dilated`` (with their group counts,
through every sub-jaxpr, a ``scan`` body times its length), a
convolution counted as torch counts one: every output position times
every tap, and for an input dilated by the stride (a transposed
convolution, a strided one's gradient) every real input element times
every tap. Tolerances:
* host mesh (1 rank) against the reference: 1 % (a tiny dense LM at one
  attention chunk, where both packages' attention computes one block;
  at longer sequences the port skips key chunks no query can reach,
  where the reference scans every chunk under a mask), and the paper
  GAN step at the reference's cuts;
* production mesh (32 x 8): cards x per-rank FLOPs within 2 % of the
  host count for prefill; the train step's ratio is held at its measured
  value (the dense MLP's ``wo`` in a block keyed ``p0_attn`` takes the
  attention output rule, 3 dims on a 2-dim weight, and stays replicated,
  so its backward runs whole on every rank of the model axis);
* collective calls equal ``launch.mesh.calls``; argument bytes equal
  the local shards' bytes: exact.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import (INPUT_SHAPES, get_config,  # noqa
                                 get_smoke_config, list_archs)
from repro_torch.launch import input_specs as tspecs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-3-2b"
TINY = dict(n_layers=2, d_model=128, n_heads=16, n_kv_heads=8, head_dim=8,
            d_ff=256, vocab=512)
# one attention chunk (512 tokens); batch 64 splits over 32 data ranks;
# the decode step over a cache of 512 (+ margin) slots
SHAPES = {"train_s512": (512, 64, "train"),
          "prefill_s512": (512, 64, "prefill"),
          "decode_s512": (512, 64, "decode")}
GAN_BATCH = 2
REF_TOL = 0.01
MESH_TOL = 0.02
# cards x per-rank / host FLOPs of the tiny train step on the 1-pod mesh
# (the replicated MLP ``wo``, module docstring)
TRAIN_MESH_RATIO = 1.1944444
# and of its decode step (``test_decode_mesh_flops``)
DECODE_MESH_RATIO = 1.0
TIMEOUT = 600
# the MoE and xLSTM families at their smoke configs: granite-moe with 8
# experts (expert parallel on the 8-way model axis, one per rank) and 8
# heads (split 8 ways, as granite-3-2b's above), xlstm-350m as it is (2
# mLSTM heads, whole on every rank of the model axis as the full
# config's 4 are; the sLSTM's 256 hidden units split 8 ways)
FAMILIES = {"granite-moe-1b-a400m": {"n_experts": 8, "n_heads": 8,
                                     "n_kv_heads": 8},
            "xlstm-350m": {}}
# cards x per-rank / host FLOPs of the xLSTM on the 1-pod mesh, measured:
# work replicated over the model axis (``test_family_production_mesh_flops``);
# the train step's fell from 3.2426570 when the sLSTM's output gate took
# its rank-local product (``dtensor_ops.rows_in``), whose weight gradient
# DTensor's rules had contracted whole on every rank
FAMILY_MESH_RATIO = {("xlstm-350m", "train_s512"): 3.0402169,
                     ("xlstm-350m", "prefill_s512"): 3.1986852,
                     ("xlstm-350m", "decode_s512"): 2.9553919,
                     ("granite-moe-1b-a400m", "decode_s512"): 1.0099668}


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, torch.Tensor):
        yield path, tuple(tree.shape), str(tree.dtype).replace("torch.", "")


def _ref_leaves(tree):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        keys = tuple(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)
        yield keys, tuple(leaf.shape), str(leaf.dtype)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match(arch):
    from repro.configs import get_config as ref_config
    from repro.launch import input_specs as rspecs
    cfg, rcfg = get_config(arch), ref_config(arch)
    for name, shape in INPUT_SHAPES.items():
        from repro.configs import INPUT_SHAPES as RSHAPES
        rshape = RSHAPES[name]
        assert (tspecs.skip_reason(cfg, shape)
                == rspecs.skip_reason(rcfg, rshape)), (arch, name)
        assert (tspecs.decode_window(cfg, shape)
                == rspecs.decode_window(rcfg, rshape)), (arch, name)
        if tspecs.skip_reason(cfg, shape):
            continue
        got, want = tspecs.input_specs(cfg, name), rspecs.input_specs(
            rcfg, name)
        assert got["kind"] == want["kind"]
        assert got.get("force_window") == want.get("force_window")
        got_t = {k: v for k, v in got.items()
                 if k not in ("kind", "force_window")}
        want_t = {k: v for k, v in want.items()
                  if k not in ("kind", "force_window")}
        if got["kind"] == "decode":
            # the port's cache length is a Python int, the reference's
            # an int32 scalar leaf
            assert got_t["cache"].pop("length") == 0
            length = want_t["cache"].pop("length")
            assert (length.shape, str(length.dtype)) == ((), "int32")
        g = sorted(_port_leaves(got_t))
        w = sorted(_ref_leaves(want_t))
        assert g == w, (arch, name)
        for t in _tensors(got_t):
            assert t.device.type == "meta"


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


# ---------------------------------------------------------------------------
# the reference's counts (parent side; JAX imported here only)
# ---------------------------------------------------------------------------

def _taps(in_len, k, out_len, lhs_dil):
    if lhs_dil == 1:
        return out_len * k
    return in_len * min(k, out_len)


def _conv_products(eqn):
    dn = eqn.params["dimension_numbers"]
    lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
    out = eqn.outvars[0].aval.shape
    nsp = len(dn.lhs_spec) - 2
    ld = eqn.params.get("lhs_dilation") or (1,) * nsp
    taps = 1
    for i in range(nsp):
        taps *= _taps(lhs[dn.lhs_spec[2 + i]], rhs[dn.rhs_spec[2 + i]],
                      out[dn.out_spec[2 + i]], ld[i])
    return (2.0 * out[dn.out_spec[0]] * out[dn.out_spec[1]]
            * rhs[dn.rhs_spec[1]] * taps)


def jaxpr_flops(jaxpr) -> float:
    """The reference's count (module docstring)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        if p == "dot_general":
            (_, rc), (_, rb) = eqn.params["dimension_numbers"]
            a, b = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            total += 2.0 * math.prod(a) * math.prod(
                b[i] for i in range(len(b)) if i not in rc and i not in rb)
        elif p == "conv_general_dilated":
            total += _conv_products(eqn)
        mult = eqn.params.get("length", 1) if p == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if hasattr(sub, "eqns"):
                    total += mult * jaxpr_flops(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    total += mult * jaxpr_flops(sub.jaxpr)
    return total


def _ref_lm_flops(arch=ARCH, over=None):
    """The reference's count of each ``SHAPES`` step of ``arch`` at
    ``TINY`` (or ``FAMILIES[arch]``: its smoke config with ``over``)."""
    import jax
    from repro.configs import INPUT_SHAPES as RSHAPES
    from repro.configs import get_config as ref_config
    from repro.configs import get_smoke_config as ref_smoke
    from repro.configs.base import InputShape
    from repro.launch.input_specs import input_specs
    from repro.models import transformer as RT
    from repro.optim import adam
    cfg = (dataclasses.replace(ref_config(ARCH), **TINY) if over is None
           else dataclasses.replace(ref_smoke(arch), **over))
    out = {}
    for name, (S, B, kind) in SHAPES.items():
        RSHAPES[name] = InputShape(name, S, B, kind)
        try:
            spec = input_specs(cfg, name)
        finally:
            del RSHAPES[name]
        params = jax.eval_shape(lambda: RT.init_lm(jax.random.PRNGKey(0),
                                                   cfg))
        if kind == "train":
            step, opt_init = RT.make_train_step(cfg, adam(1e-4,
                                                          grad_clip=1.0))
            jp = jax.make_jaxpr(step)(params, jax.eval_shape(opt_init,
                                                             params),
                                      spec["batch"])
        elif kind == "decode":
            jp = jax.make_jaxpr(lambda p, t, c: RT.decode_step(
                cfg, p, t, c, force_window=spec["force_window"]))(
                    params, spec["token"], spec["cache"])
        else:
            jp = jax.make_jaxpr(lambda p, b: RT.prefill(
                cfg, p, b["tokens"]))(params, spec["batch"])
        out[name] = jaxpr_flops(jp.jaxpr)
    return out


# the reference's GAN step, counted in a process of its own (importing
# repro.launch.dryrun_paper forces 512 host devices)
_REF_GAN = f"""
import json, sys
sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})
import jax
import repro.launch.dryrun_paper as DP
from test_torch_dryrun import jaxpr_flops
groups, ga = DP.build_gan_population(224, {GAN_BATCH})
step = DP.build_gan_step(groups, {GAN_BATCH})
jp = jax.make_jaxpr(step)(DP.gan_state_struct(groups),
                          DP.gan_batch_struct(groups, {GAN_BATCH}))
cuts = sorted((c, g.cut.g_h, g.cut.g_t, g.cut.d_h, g.cut.d_t)
              for g in groups for c in g.client_ids)
print(json.dumps({{"flops": jaxpr_flops(jp.jaxpr), "cuts": cuts,
                  "latency": float(ga.latency)}}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return env


# ---------------------------------------------------------------------------
# the port's side, in a spawned process (no JAX)
# ---------------------------------------------------------------------------

def _arg_bytes(lowered) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in _tensors_deep(lowered.args):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def _tensors_deep(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors_deep(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors_deep(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def torch_child(in_path: str, out_path: str) -> None:
    """Every traced step the tests check, in this (fresh) process."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import dryrun_paper as DP  # noqa: F401
    from repro_torch.launch import roofline  # noqa: F401
    from repro_torch.launch import mesh as M
    out = {"group_after_import": dist.is_initialized()}
    with open(in_path) as f:
        inp = json.load(f)
    shapes = {name: InputShape(name, S, B, kind)
              for name, (S, B, kind) in SHAPES.items()}
    cfg = dataclasses.replace(get_config(ARCH), **TINY)
    for where in ("host", "1pod"):
        mesh = (D.host_mesh("cpu") if where == "host"
                else D.production_mesh(False, "cpu"))
        for name, shape in shapes.items():
            lowered, meta = D.build_lowered(ARCH, shape, multi_pod=False,
                                            cfg_override=cfg, mesh=mesh,
                                            device="cpu")
            want = _arg_bytes(lowered)
            res = D.analyze(lowered, meta)
            D.calibrate_scan_costs(ARCH, name, False, None, res)
            res["expected_argument_bytes"] = want
            out[f"{where}/{name}"] = res
        for arch, over in FAMILIES.items():
            fcfg = dataclasses.replace(get_smoke_config(arch), **over)
            for name, shape in shapes.items():
                out[f"{where}/{arch}/{name}"] = D.run_pair(
                    arch, shape, False, device="cpu", mesh=mesh,
                    cfg_override=fcfg)
    # the recurrences' steps replayed against run one by one (32 tokens)
    xcfg = get_smoke_config("xlstm-350m")
    short = InputShape("train_s32", 32, 64, "train")
    out["replay/steps"] = D.run_pair("xlstm-350m", short, False,
                                     device="cpu", mesh=D.host_mesh("cpu"),
                                     cfg_override=xcfg)
    enter, leave = D._StepReplay.__enter__, D._StepReplay.__exit__
    D._StepReplay.__enter__ = lambda self: self
    D._StepReplay.__exit__ = lambda self, *exc: False
    try:
        out["replay/every_step"] = D.run_pair(
            "xlstm-350m", short, False, device="cpu",
            mesh=D.host_mesh("cpu"), cfg_override=xcfg)
    finally:
        D._StepReplay.__enter__, D._StepReplay.__exit__ = enter, leave
    # the paper's GAN step at the reference's cuts
    from repro_torch.core.latency import PAPER_DEVICES, Cut
    from repro_torch.core.splitting import group_by_profile
    devices = [PAPER_DEVICES[p] for p in range(7) for _ in range(32)]
    groups = group_by_profile(devices,
                              [Cut(*c[1:]) for c in sorted(inp["cuts"])])
    for where in ("host", "1pod", "2pod"):
        mesh = (D.host_mesh("cpu") if where == "host"
                else D.production_mesh(where == "2pod", "cpu"))
        M.calls.clear()
        res = DP.run_gan(where == "2pod", batch=GAN_BATCH, device="cpu",
                         mesh=mesh, groups=groups,
                         ga_latency=inp["latency"])
        res["mesh_calls"] = dict(M.calls)
        out[f"{where}/gan"] = res
    D.stop_fake_group()
    # a default group of another backend is refused
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        D.start_fake_group(256)
        out["refused_other_backend"] = False
    except RuntimeError:
        out["refused_other_backend"] = True
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    ref_gan = subprocess.Popen([sys.executable, "-c", _REF_GAN], cwd=ROOT,
                               env=_env(), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    lm = _ref_lm_flops()
    families = {arch: _ref_lm_flops(arch, over)
                for arch, over in FAMILIES.items()}
    gan_out, gan_err = ref_gan.communicate(timeout=TIMEOUT)
    assert ref_gan.returncode == 0, gan_err[-4000:]
    ref = json.loads(gan_out.strip().splitlines()[-1])
    inp, res = tmp / "in.json", tmp / "out.json"
    inp.write_text(json.dumps({"cuts": ref["cuts"],
                               "latency": ref["latency"]}))
    code = ("import test_torch_dryrun as m; "
            f"m.torch_child({str(inp)!r}, {str(res)!r})")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"ref_lm": lm, "ref_gan": ref["flops"], "ref_families": families,
            "port": json.loads(res.read_text())}


def test_import_starts_no_group(runs):
    assert runs["port"]["group_after_import"] is False
    assert runs["port"]["refused_other_backend"] is True


@pytest.mark.parametrize("name", list(SHAPES))
def test_host_flops_match_reference(runs, name):
    got = runs["port"][f"host/{name}"]["cost"]["flops"]
    want = runs["ref_lm"][name]
    assert abs(got / want - 1) < REF_TOL, (got, want)


def test_production_mesh_flops(runs):
    host = runs["port"]["host/prefill_s512"]
    prod = runs["port"]["1pod/prefill_s512"]
    assert prod["chips"] == 256
    ratio = prod["chips"] * prod["cost"]["flops"] / host["cost"]["flops"]
    assert abs(ratio - 1) < MESH_TOL, ratio
    host = runs["port"]["host/train_s512"]
    prod = runs["port"]["1pod/train_s512"]
    ratio = prod["chips"] * prod["cost"]["flops"] / host["cost"]["flops"]
    assert abs(ratio / TRAIN_MESH_RATIO - 1) < MESH_TOL, ratio


def test_decode_mesh_flops(runs):
    """The tiny decode step on the 256-card mesh: cards x per-rank FLOPs
    equal the host count, nothing repeated across the model axis. The
    decode block takes the prefill's layout sites (its sublayer inputs
    ``resid_inner``, their outputs joining the residual stream as
    ``resid``), so the q/k/v projections contract the norm's output,
    whole on the model axis, with the heads' split of their weights.
    Before, DTensor's rules chose that input's layout: the projections
    ran on every rank of the model axis here (1.727), and what each
    torch version left of the sums of partial products differed."""
    host = runs["port"]["host/decode_s512"]
    prod = runs["port"]["1pod/decode_s512"]
    assert prod["chips"] == 256
    ratio = prod["chips"] * prod["cost"]["flops"] / host["cost"]["flops"]
    assert abs(ratio / DECODE_MESH_RATIO - 1) < MESH_TOL, ratio


def test_train_step_collectives(runs):
    coll = runs["port"]["1pod/train_s512"]["collectives"]
    assert coll.get("all-reduce", 0) > 0
    assert coll.get("all-gather", 0) + coll.get("reduce-scatter", 0) > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    # the host mesh moves nothing
    assert runs["port"]["host/train_s512"]["collectives"]["total"] == 0


@pytest.mark.parametrize("key", ["host/train_s512", "host/prefill_s512",
                                 "1pod/train_s512", "1pod/prefill_s512"])
def test_argument_bytes_and_record(runs, key):
    res = runs["port"][key]
    mem = res["memory"]
    assert mem["argument_bytes"] == res["expected_argument_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert res["cost_corrected"]["flops"] == res["cost"]["flops"]
    assert res["scan_correction"] == 1.0


def test_gan_step_matches_reference(runs):
    host = runs["port"]["host/gan"]
    assert abs(host["cost"]["flops"] / runs["ref_gan"] - 1) < REF_TOL
    assert host["collectives"]["total"] == 0 and host["chips"] == 1


def test_gan_step_on_the_meshes(runs):
    one = runs["port"]["1pod/gan"]
    assert one["variant"] == "paper-concat" and one["chips"] == 256
    assert one["rows_per_rank"] == 7            # 7 groups of 32 over 32
    calls = one["collective_calls"]
    assert calls == {"all-reduce": one["mesh_calls"]["all_reduce"]}
    assert calls["all-reduce"] > 0
    two = runs["port"]["2pod/gan"]
    assert two["variant"] == "paper-concat+replicated"
    assert two["rows_per_rank"] == 224 and two["collectives"]["total"] == 0
    # every rank of the replicated step runs the whole population
    host = runs["port"]["host/gan"]
    assert two["cost"]["flops"] == host["cost"]["flops"]


def test_main_runs_each_pair_in_a_worker(tmp_path):
    """``main`` as a user runs it: every pair in a spawned worker with a
    fake group of its own of the mesh's size (this process starts none),
    one JSONL record per pair, exit 0 when no pair errs. whisper-tiny's
    long_500k pairs are skipped by the input specs, so nothing of a
    full-size model is traced here."""
    out = tmp_path / "d.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "long_500k", "--both-meshes",
         "--device", "cpu", "--out", str(out)], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = sorted((json.loads(line) for line in out.read_text().splitlines()),
                  key=lambda r: r["multi_pod"])
    assert [r["multi_pod"] for r in recs] == [False, True]
    want = tspecs.skip_reason(get_config("whisper-tiny"),
                              INPUT_SHAPES["long_500k"])
    for r in recs:
        assert (r["arch"], r["shape"]) == ("whisper-tiny", "long_500k")
        assert r["skipped"] == want and r["wall_s"] >= 0
    assert proc.stdout.count("[dryrun] whisper-tiny x long_500k") == 2


FAMILY_PAIRS = [(a, n) for a in FAMILIES for n in SHAPES]


@pytest.mark.parametrize("arch,name", FAMILY_PAIRS)
def test_family_host_flops_match_reference(runs, arch, name):
    """The MoE and xLSTM steps on one rank count the reference's jaxpr
    FLOPs: the MoE's router, dispatch, expert and combine einsums, the
    recurrences' per-token products (a ``scan`` body times its
    length)."""
    got = runs["port"][f"host/{arch}/{name}"]["cost"]["flops"]
    want = runs["ref_families"][arch][name]
    assert abs(got / want - 1) < REF_TOL, (got, want)


@pytest.mark.parametrize("arch,name", FAMILY_PAIRS)
def test_family_production_mesh_flops(runs, arch, name):
    """Cards x per-rank FLOPs against the host count on the 256-card
    mesh. The MoE within ``MESH_TOL``: each rank runs its own batch rows
    through its own expert (no expert's work repeated across the model
    axis), its 8 heads split 8 ways; only the router repeats (1 %, the
    decode step's ratio pinned at 1.00997). The xLSTM at its measured
    ratio: its mLSTM's 2 heads stay whole on every rank of the 8-way
    model axis (``policy.sanitize``), so the block's q/k/v/gate
    projections and its per-token loop run 8 times over (0.316 of the
    host count: 1 + 7 x 0.316 = 3.2 for prefill; the backward and the
    checkpoint's recomputation repeat them too), as the full config's 4
    heads do; its out projection splits ``hd`` and the sLSTM its hidden
    units (its output gate, whose weight splits d_model, on each rank's
    shards: ``dtensor_ops.rows_in``). At decode the same: the mLSTM's
    five projections and its one-step cell (``dtensor_ops.local_step``)
    run 8 times over, 0.2794 of the host count (1 + 7 x 0.2794 = 2.955),
    nothing else repeats. Before the decode block took the prefill's
    layout sites, DTensor's rules chose the layout of the norms' outputs
    there, and the tiny granite-moe's q/k/v projections and the xLSTM's
    sLSTM gate projections ran on every rank of the model axis as well
    (2.126 and 5.284), by rules that differ by torch version."""
    host = runs["port"][f"host/{arch}/{name}"]
    prod = runs["port"][f"1pod/{arch}/{name}"]
    assert prod["chips"] == 256 and "error" not in prod
    ratio = prod["chips"] * prod["cost"]["flops"] / host["cost"]["flops"]
    want = FAMILY_MESH_RATIO.get((arch, name), 1.0)
    assert abs(ratio / want - 1) < MESH_TOL, ratio


PAIR_LIMIT_S = 4


def _blocking_pair(arch, shape, mp, policy, device):
    """A pair that never ends, in a call that does not return to Python:
    SIGALRM blocked, then a sleep (an alarm in the worker could never
    fire)."""
    import signal
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(3600)


def test_pair_past_its_limit_is_an_error_record():
    """The parent holds each worker to its deadline: a worker blocked
    past it is terminated and its pair comes back as an ``error`` record
    with its wall time, within a few seconds of the limit."""
    from repro_torch.launch import dryrun as D
    from repro_torch.sharding.policy import ShardingPolicy
    t0 = time.time()
    recs = D.run_pairs([("xlstm-350m", "train_4k", False)], ShardingPolicy(),
                       "cpu", 1, timeout=PAIR_LIMIT_S, fn=_blocking_pair)
    wall = time.time() - t0
    assert len(recs) == 1
    rec = recs[0]
    assert (rec["arch"], rec["shape"], rec["multi_pod"]) == (
        "xlstm-350m", "train_4k", False)
    assert rec["error"] == f"traced past {PAIR_LIMIT_S} s"
    assert PAIR_LIMIT_S <= rec["wall_s"] <= PAIR_LIMIT_S + 3, rec
    assert wall <= PAIR_LIMIT_S + 10, wall


# cards x per-card peak / host peak of the tiny MoE on the 1-pod mesh:
# measured 1.094 (train) and 1.12 (prefill); DTensor's own rules, which
# build the dispatch and combine buffers at the global batch on every
# rank, give 18 and 30
MOE_PEAK_SPLIT = 1.25


@pytest.mark.parametrize("name", ["train_s512", "prefill_s512"])
def test_moe_buffers_split_over_the_mesh(runs, name):
    """The rank-local expert dispatch holds each card's own batch rows
    and experts of the ``[B, S, E, C]`` dispatch and combine buffers, so
    the cards' peaks add up to about the host's (the router, repeated on
    the model axis, and a layer's gathered parameters above it)."""
    arch = "granite-moe-1b-a400m"
    host = runs["port"][f"host/{arch}/{name}"]["memory"]["peak_bytes"]
    prod = runs["port"][f"1pod/{arch}/{name}"]
    ratio = prod["chips"] * prod["memory"]["peak_bytes"] / host
    assert ratio <= MOE_PEAK_SPLIT, ratio


def test_step_replay_counts_every_step(runs):
    """The dry run's replay of the recurrences' per-token steps
    (``dryrun._StepReplay``) against the same trace running every step:
    the FLOPs exactly, the bytes within 1e-3, the peak within 3 % (its
    stand-in of a step's saved tensors)."""
    rep = runs["port"]["replay/steps"]
    every = runs["port"]["replay/every_step"]
    assert rep["cost"]["flops"] == every["cost"]["flops"] > 0
    assert rep["collectives"] == every["collectives"]
    got, want = rep["cost"]["bytes_accessed"], every["cost"]["bytes_accessed"]
    assert abs(got / want - 1) < 1e-3, (got, want)
    got, want = rep["memory"]["peak_bytes"], every["memory"]["peak_bytes"]
    assert abs(got / want - 1) < 0.03, (got, want)


def _site_record(torch_version, sites, **totals):
    rec = {"arch": "xlstm-350m", "shape": "decode_32k", "multi_pod": False,
           "flops": 0.0, "peak_bytes": 100, "collectives": {},
           "torch": torch_version, "sites": sites}
    rec.update(totals)
    return rec


def test_dryrun_peak_diff(tmp_path, capsys):
    """``scripts/dryrun_peak.py --diff A B`` on two hand-made ``--by-site``
    records: the totals that differ, then each site whose FLOPs or
    collective bytes of a kind differ, summed over its DTensor and local
    operations (named differently by two torch versions), largest
    difference first; exit 1, and 0 on equal records."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "dryrun_peak", os.path.join(ROOT, "scripts", "dryrun_peak.py"))
    peak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(peak)
    cell = "models/recurrent.py:170 _mlstm_cell"
    a = _site_record("2.11.0", [
        {"site": cell, "dtensor_op": "mul", "op": "all_reduce",
         "all-reduce": 5e7, "all-reduce calls": 12},
        {"site": "models/recurrent.py:145 _mlstm_qkvg", "dtensor_op": "bmm",
         "op": "bmm", "flops": 8.0},
        {"site": "models/recurrent.py:146 _mlstm_qkvg", "dtensor_op": "bmm",
         "op": "bmm", "flops": 8.0}],
        flops=16.0, collectives={"all-reduce": 5e7})
    b = _site_record("2.13.0", [
        {"site": "models/transformer.py:332 block_decode",
         "dtensor_op": "copy_", "op": "all_reduce", "all-reduce": 5e7,
         "all-reduce calls": 24},
        {"site": "models/recurrent.py:145 _mlstm_qkvg", "dtensor_op": "mm",
         "op": "mm", "flops": 5.0},
        {"site": "models/recurrent.py:145 _mlstm_qkvg", "dtensor_op": "bmm",
         "op": "bmm", "flops": 3.0},
        {"site": "models/recurrent.py:146 _mlstm_qkvg", "dtensor_op": "bmm",
         "op": "bmm", "flops": 1.0},
        {"site": cell, "dtensor_op": "mul", "op": "reduce_scatter_tensor",
         "reduce-scatter": 4.0, "reduce-scatter calls": 1}],
        flops=9.0, collectives={"all-reduce": 5e7, "reduce-scatter": 4.0})
    assert peak.diff_records(a, b) == [
        ("total", "flops", 16.0, 9.0),
        ("total", "reduce-scatter", 0.0, 4.0),
        (cell, "all-reduce", 5e7, 0.0),
        ("models/transformer.py:332 block_decode", "all-reduce", 0.0, 5e7),
        ("models/recurrent.py:146 _mlstm_qkvg", "flops", 8.0, 1.0),
        (cell, "reduce-scatter", 0.0, 4.0)]
    pa, pb = tmp_path / "a.log", tmp_path / "b.log"
    pa.write_text("xlstm-350m x decode_32k: ...\n" + json.dumps(a) + "\n")
    pb.write_text(json.dumps(b) + "\n")
    assert peak.main(["--diff", str(pa), str(pb)]) == 1
    printed = capsys.readouterr().out
    assert printed.splitlines()[-1] == "6 differences"
    assert f"  {cell}  all-reduce: A 5e+07  B 0  (B - A -5e+07)" in printed
    assert peak.main(["--diff", str(pa), str(pa)]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "0 differences"
