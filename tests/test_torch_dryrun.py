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

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs  # noqa
from repro_torch.launch import input_specs as tspecs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-3-2b"
TINY = dict(n_layers=2, d_model=128, n_heads=16, n_kv_heads=8, head_dim=8,
            d_ff=256, vocab=512)
# one attention chunk (512 tokens); batch 64 splits over 32 data ranks
SHAPES = {"train_s512": (512, 64, "train"),
          "prefill_s512": (512, 64, "prefill")}
GAN_BATCH = 2
REF_TOL = 0.01
MESH_TOL = 0.02
# cards x per-rank / host FLOPs of the tiny train step on the 1-pod mesh
# (the replicated MLP ``wo``, module docstring)
TRAIN_MESH_RATIO = 1.1944444
TIMEOUT = 600


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


def _ref_lm_flops():
    import jax
    from repro.configs import INPUT_SHAPES as RSHAPES
    from repro.configs import get_config as ref_config
    from repro.configs.base import InputShape
    from repro.launch.input_specs import input_specs
    from repro.models import transformer as RT
    from repro.optim import adam
    cfg = dataclasses.replace(ref_config(ARCH), **TINY)
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
    return {"ref_lm": lm, "ref_gan": ref["flops"],
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
