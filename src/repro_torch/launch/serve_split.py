"""U-shaped split serving of the cGAN and of a small LM (port of
``repro.launch.serve_split``).

GAN mode serves generation requests over a heterogeneous population with
the schedule the paper trains under: each request's head and tail run on
its own client's personal weights, and the server runs every cut's
uplinked rows of a layer together. Requests are grouped by the owning
client's profile group (= cut); each group's rows pad to a power-of-two
bucket. The executor is ``segments.make_apply`` in eval mode over the
program compiled from the active groups only, cached per active set, so
an absent cut's join barrier and server layers drop out of the schedule.
``predict_latency`` evaluates the same program analytically (Eq. 7 and
Eq. 9, forward only).

LM mode applies the U-shape to a decoder-only transformer: client-owned
bottom and top blocks wrap a server trunk. On the card every block's
attention is a hand-written kernel, ``ops.mem_attention`` (K3) for the
prefill and ``ops.flash_decode`` (K4) for each decoded token; the
reference sends its client blocks to the dense plain version, which is
the same function. Generation is a Python loop over tokens that never
waits on the host until the tokens are read back.

  PYTHONPATH=src python -m repro_torch.launch.serve_split --mode gan \\
      --mix edge-heavy --requests 24
  PYTHONPATH=src python -m repro_torch.launch.serve_split --mode lm \\
      --batch 2 --prompt-len 32 --gen 16

``--device`` defaults to ``cuda`` and raises without a GPU; ``--device
cpu`` runs the kernels' plain versions. Float32 products and
convolutions run in full float32 (TF32 off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.latency import Cut, DeviceProfile, PAPER_DEVICES, PAPER_SERVER
from repro_torch.core.segments import (SplitProgram, compile_split_program,
                                       make_apply, program_forward_latency)
from repro_torch.core.splitting import (ProfileGroup, bucket_size,
                                        group_by_profile, server_union_span)
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import nn
from repro_torch.models.gan import DISC_LAYER_DEFS, GEN_LAYER_DEFS, Z_DIM
from repro_torch.tree import tree_map


# ---------------------------------------------------------------------------
# GAN split serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeRequest:
    """One generation request: which client it belongs to (that client's
    personal head/tail weights serve it) plus the conditional inputs."""
    client_id: int
    z: np.ndarray          # [Z_DIM] latent
    y: int                 # class label


class SplitGanEngine:
    """Batched split-cGAN inference over a heterogeneous population.

    ``client_params`` / ``server_params`` use the trainer's layout
    (``state["G"]["client"]`` / ``["server"]``): per-group dicts of
    client-stacked layer trees, and the server's union-span layers.
    """

    def __init__(self, groups: Sequence[ProfileGroup],
                 client_params: Dict[str, Dict[str, Any]],
                 server_params: Dict[str, Any], net: str = "G",
                 mesh=None, policy=None):
        if mesh is not None or policy is not None:
            raise NotImplementedError("sharded serving (mesh=, policy=) is "
                                      "not ported (ROADMAP M10, mesh code)")
        self.groups = list(groups)
        self.net = net
        self.client_params = client_params
        self.server_params = server_params
        self._row_of: Dict[int, Tuple[str, int]] = {}
        for g in self.groups:
            for row, cid in enumerate(g.client_ids):
                self._row_of[cid] = (g.name, row)
        self._group_of = {g.name: g for g in self.groups}
        self._programs: Dict[Tuple[str, ...], SplitProgram] = {}
        self._applies: Dict[Tuple[str, ...], Callable] = {}

    @property
    def device(self) -> torch.device:
        return _first_leaf(self.client_params).device

    # -- program / executor caches -----------------------------------------
    def program_for(self, active: Tuple[str, ...]) -> SplitProgram:
        """Subprogram over the active groups only: absent cuts drop their
        join barriers (and possibly whole server layers) from the
        schedule."""
        if active not in self._programs:
            subset = [self._group_of[n] for n in active]
            self._programs[active] = compile_split_program(subset, self.net)
        return self._programs[active]

    def _apply(self, active: Tuple[str, ...]) -> Callable:
        if active not in self._applies:
            self._applies[active] = make_apply(self.program_for(active))
        return self._applies[active]

    # -- serving -------------------------------------------------------------
    def plan(self, requests: Sequence[ServeRequest]
             ) -> Tuple[Tuple[str, ...], Tuple[int, ...], Dict[str, List[int]]]:
        """(active group names, buckets, per-group request indices)."""
        per: Dict[str, List[int]] = {}
        for i, r in enumerate(requests):
            gname, _ = self._row_of[r.client_id]
            per.setdefault(gname, []).append(i)
        active = tuple(g.name for g in self.groups if g.name in per)
        buckets = tuple(bucket_size(len(per[g])) for g in active)
        return active, buckets, per

    def serve(self, requests: Sequence[ServeRequest]) -> np.ndarray:
        """Run the cohort through the U-shaped program; [N, 28, 28, 1]
        images in request order."""
        active, buckets, per = self.plan(requests)
        apply = self._apply(active)
        dev = self.device
        gathered, inputs = {}, {}
        for g, bkt in zip(active, buckets):
            idxs = per[g]
            rows = np.zeros(bkt, np.int64)
            z = np.zeros((bkt, Z_DIM), np.float32)
            y = np.zeros(bkt, np.int32)
            for j, i in enumerate(idxs):
                req = requests[i]
                rows[j] = self._row_of[req.client_id][1]
                z[j] = req.z
                y[j] = req.y
            # bucket-padding rows replay row 0 with zero inputs: eval-mode
            # BatchNorm is per element, so they cannot touch valid rows;
            # they are dropped below. Each request is one copy (K) of its
            # client's layers, with a batch of one.
            rows_t = torch.as_tensor(rows, device=dev)
            gathered[g] = tree_map(lambda t: t.index_select(0, rows_t),
                                   self.client_params[g])
            inputs[g] = (torch.as_tensor(z, device=dev)[:, None, :],
                         torch.as_tensor(y, device=dev)[:, None])
        with torch.no_grad():
            out, _, _, _ = apply(gathered, self.server_params, inputs, False)
        out = {g: out[g][:, 0].cpu().numpy() for g in active}
        first = out[active[0]]
        imgs = np.zeros((len(requests),) + first.shape[1:], first.dtype)
        for g in active:
            for j, i in enumerate(per[g]):
                imgs[i] = out[g][j]
        return imgs

    def predict_latency(self, requests: Sequence[ServeRequest],
                        server: DeviceProfile = PAPER_SERVER,
                        padded: bool = True) -> float:
        """Analytic Eq. 7/9 forward latency for this cohort from the same
        program the executor runs. ``padded=True`` bills the
        bucket-padded multiplicities (what executes); ``False`` only the
        real requests."""
        active, buckets, per = self.plan(requests)
        program = self.program_for(active)
        profiles = {g: self._group_of[g].profile for g in active}
        counts = {g: float(b) if padded else float(len(per[g]))
                  for g, b in zip(active, buckets)}
        return program_forward_latency(program, profiles, server,
                                       batch=1, counts=counts)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def init_gan_serving_state(gen: torch.Generator,
                           groups: Sequence[ProfileGroup], net: str = "G",
                           device="cuda"
                           ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Random split-cGAN weights in the trainer's state layout, drawn
    from ``gen`` (the engine normally serves a trained state; the
    launcher serves random weights, and latency does not depend on
    them). The engine serves wherever its weights are."""
    device = resolve_device(device)
    defs = GEN_LAYER_DEFS if net == "G" else DISC_LAYER_DEFS
    n = len(defs)
    server = {str(l): tree_map(lambda t: t[0], defs[l].init(1, gen, device))
              for l in server_union_span(groups, net, n)}
    client = {}
    for g in groups:
        h, t = (g.cut.g_h, g.cut.g_t) if net == "G" else (g.cut.d_h, g.cut.d_t)
        client[g.name] = {str(l): defs[l].init(g.size, gen, device)
                          for l in list(range(h)) + list(range(t, n))}
    return client, server


# Two heterogeneous profile mixes (paper Table 4 devices): name -> list of
# (device, cut, n_clients). Weak devices delegate almost everything
# (head 1 / tail 4); strong devices keep two layers per side.
SERVE_MIXES: Dict[str, List[Tuple[DeviceProfile, Cut, int]]] = {
    "edge-heavy": [
        (PAPER_DEVICES[0], Cut(1, 4, 1, 4), 4),   # device1, weakest
        (PAPER_DEVICES[4], Cut(1, 4, 1, 4), 3),   # device5
        (PAPER_DEVICES[1], Cut(2, 3, 2, 3), 2),   # device2
    ],
    "balanced": [
        (PAPER_DEVICES[1], Cut(1, 4, 1, 4), 2),   # device2
        (PAPER_DEVICES[3], Cut(2, 4, 1, 4), 2),   # device4
        (PAPER_DEVICES[2], Cut(2, 3, 2, 3), 2),   # device3
        (PAPER_DEVICES[6], Cut(2, 3, 2, 3), 2),   # device7
    ],
}


def build_mix(mix: str) -> List[ProfileGroup]:
    devices, cuts = [], []
    for dev, cut, n in SERVE_MIXES[mix]:
        devices += [dev] * n
        cuts += [cut] * n
    return group_by_profile(devices, cuts)


# ---------------------------------------------------------------------------
# LM split decode tail: U-shaped transformer serving on kernels K3 and K4
# ---------------------------------------------------------------------------

class SplitLMConfig(NamedTuple):
    """A compact decoder-only LM split client-head / server-trunk /
    client-tail: blocks [0, head_end) and [tail_start, n_layers) stay on
    the client, [head_end, tail_start) run on the server."""
    vocab: int = 256
    d_model: int = 64
    n_layers: int = 4
    n_heads: int = 4
    n_kv: int = 2
    head_dim: int = 16
    d_ff: int = 128
    head_end: int = 1
    tail_start: int = 3
    s_max: int = 160

    def is_server(self, l: int) -> bool:
        return self.head_end <= l < self.tail_start


def _lm_block_init(cfg: SplitLMConfig, gen, device):
    return {
        "ln1": nn.rmsnorm_init(cfg.d_model, device),
        "attn": A.attn_init(cfg.d_model, cfg.n_heads, cfg.n_kv,
                            cfg.head_dim, gen, device),
        "ln2": nn.rmsnorm_init(cfg.d_model, device),
        "wi": nn.linear_init(cfg.d_model, cfg.d_ff, gen, device),
        "wo": nn.linear_init(cfg.d_ff, cfg.d_model, gen, device),
    }


def init_split_lm(gen: torch.Generator, cfg: SplitLMConfig, device="cuda"):
    """Random LM weights in the reference's layout: {"embed" [V, d],
    "blocks": [per-block trees], "norm_f"}. The LM runs wherever its
    weights are."""
    device = resolve_device(device)
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=gen) * 0.02
             ).to(device)
    return {"embed": embed,
            "blocks": [_lm_block_init(cfg, gen, device)
                       for _ in range(cfg.n_layers)],
            "norm_f": nn.rmsnorm_init(cfg.d_model, device)}


def _lm_mlp(p, x):
    return nn.linear_apply(p["wo"], nn.gelu(nn.linear_apply(p["wi"], x)))


def _lm_block_prefill(p, x, positions, lens, attention: Callable):
    """One block over the whole prompt; returns (y, (k, v)) for the
    cache. ``attention`` is ``ops.mem_attention`` on the serving path and
    the dense plain version in the oracle."""
    h = nn.rmsnorm_apply(p["ln1"], x)
    q, k, v = A.qkv_proj(p["attn"], h)
    q = A.apply_rope(q, positions)
    k = A.apply_rope(k, positions)
    o = attention(q, k, v, lens, causal=True)
    x = x + A.out_proj(p["attn"], o)
    return x + _lm_mlp(p, nn.rmsnorm_apply(p["ln2"], x)), (k, v)


def _lm_block_decode(p, x, ck, cv, t: int):
    """One block for one token at position ``t``; writes the token's k/v
    into the [B, s_max, KV, hd] caches in place (the reference returns
    new caches from ``dynamic_update_slice``) and attends with K4."""
    h = nn.rmsnorm_apply(p["ln1"], x)
    q, k, v = A.qkv_proj(p["attn"], h)                 # [B, 1, N, hd]
    pos = torch.arange(t, t + 1, device=x.device)
    q = A.apply_rope(q, pos)
    k = A.apply_rope(k, pos)
    ck[:, t] = k[:, 0]
    cv[:, t] = v[:, 0]
    o = ops.flash_decode(q[:, 0], ck, cv, t + 1)[:, None]
    x = x + A.out_proj(p["attn"], o)
    return x + _lm_mlp(p, nn.rmsnorm_apply(p["ln2"], x))


def split_lm_prefill(cfg: SplitLMConfig, params, tokens: torch.Tensor):
    """U-shaped prefill (every block on K3): returns (last-position
    logits [B, V], [(k cache, v cache)] per block)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)
    lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    caches = []
    for blk in params["blocks"]:
        x, (k, v) = _lm_block_prefill(blk, x, positions, lens,
                                      ops.mem_attention)
        ck = torch.zeros((B, cfg.s_max, cfg.n_kv, cfg.head_dim),
                         dtype=k.dtype, device=k.device)
        cv = torch.zeros_like(ck)
        ck[:, :S] = k
        cv[:, :S] = v
        caches.append((ck, cv))
    x = nn.rmsnorm_apply(params["norm_f"], x[:, -1])
    return x @ params["embed"].T, caches


def _lm_step(cfg: SplitLMConfig, params, cur: torch.Tensor, caches,
             t: int) -> torch.Tensor:
    """One decode token through the U-shape (every block on K4); the
    caches advance in place. Returns logits [B, V]."""
    x = params["embed"][cur.long()][:, None, :]
    for blk, (ck, cv) in zip(params["blocks"], caches):
        x = _lm_block_decode(blk, x, ck, cv, t)
    x = nn.rmsnorm_apply(params["norm_f"], x[:, 0])
    return x @ params["embed"].T


@torch.no_grad()
def split_lm_generate(cfg: SplitLMConfig, params, tokens: torch.Tensor,
                      n_gen: int) -> torch.Tensor:
    """Greedy generation: [B, n_gen] tokens (int32) on the prompt's
    device. One prefill, then ``n_gen - 1`` decode steps."""
    logits, caches = split_lm_prefill(cfg, params, tokens)
    cur = torch.argmax(logits, -1).to(torch.int32)
    out = [cur]
    t = tokens.shape[1]
    for _ in range(n_gen - 1):
        cur = torch.argmax(_lm_step(cfg, params, cur, caches, t), -1
                           ).to(torch.int32)
        out.append(cur)
        t += 1
    return torch.stack(out, 1)


@torch.no_grad()
def split_lm_decode_logits(cfg: SplitLMConfig, params, tokens: torch.Tensor,
                           prompt_len: int) -> torch.Tensor:
    """Teacher-forced per-step decode logits for tokens[:, prompt_len:]:
    [B, S - prompt_len, V], where slot i holds the logits emitted after
    consuming tokens[:, prompt_len + i - 1] (slot 0 from the prefill)."""
    logits0, caches = split_lm_prefill(cfg, params, tokens[:, :prompt_len])
    out = [logits0]
    for t in range(prompt_len, tokens.shape[1] - 1):
        out.append(_lm_step(cfg, params, tokens[:, t], caches, t))
    return torch.stack(out, 1)


@torch.no_grad()
def lm_reference_logits(cfg: SplitLMConfig, params, tokens: torch.Tensor
                        ) -> torch.Tensor:
    """Monolithic dense-attention forward over the full sequence (no
    split, no kernels, no caches), the oracle the engine must match:
    [B, S, V]."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)
    lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
    for blk in params["blocks"]:
        x, _ = _lm_block_prefill(blk, x, positions, lens,
                                 ref.mem_attention_ref)
    x = nn.rmsnorm_apply(params["norm_f"], x)
    return x @ params["embed"].T


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_gan(args, device: torch.device) -> Dict[str, Any]:
    groups = build_mix(args.mix)
    gen = torch.Generator().manual_seed(args.seed)
    client, server = init_gan_serving_state(gen, groups, device=device)
    engine = SplitGanEngine(groups, client, server)
    rng = np.random.default_rng(args.seed)
    n_clients = sum(g.size for g in groups)
    reqs = [ServeRequest(int(rng.integers(0, n_clients)),
                         rng.normal(0, 1, Z_DIM).astype(np.float32),
                         int(rng.integers(0, 10)))
            for _ in range(args.requests)]
    active, buckets, per = engine.plan(reqs)
    print(f"[serve_split] mix={args.mix} requests={len(reqs)} "
          f"active_cuts={len(active)} buckets={list(buckets)}")
    engine.serve(reqs)                       # warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        imgs = engine.serve(reqs)
    measured = (time.perf_counter() - t0) / args.iters
    analytic = engine.predict_latency(reqs)
    print(f"[serve_split] images={imgs.shape} "
          f"measured={measured * 1e3:.1f}ms analytic={analytic * 1e3:.2f}ms "
          f"ratio={measured / analytic:.2f}")
    return {"engine": engine, "requests": reqs, "images": imgs,
            "measured_s": measured, "analytic_s": analytic}


def _run_lm(args, device: torch.device) -> Dict[str, Any]:
    cfg = SplitLMConfig(s_max=args.prompt_len + args.gen + 16)
    params = init_split_lm(torch.Generator().manual_seed(args.seed), cfg,
                           device)
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (args.batch, args.prompt_len)),
                             dtype=torch.int32, device=device)
    split_lm_generate(cfg, params, tokens, args.gen)        # warm
    _sync(device)
    t0 = time.perf_counter()
    toks = split_lm_generate(cfg, params, tokens, args.gen).cpu().numpy()
    dt = time.perf_counter() - t0
    where = ("attention kernels K3/K4" if device.type == "cuda"
             else "plain attention")
    print(f"[serve_split] lm decode {args.batch}x{args.gen} "
          f"(server blocks [{cfg.head_end},{cfg.tail_start}); every block "
          f"on {where}): {dt:.2f}s "
          f"({args.batch * args.gen / max(dt, 1e-9):.0f} tok/s)")
    print(f"[serve_split] sample continuation (seq 0): "
          f"{toks[0][:16].tolist()}")
    return {"cfg": cfg, "params": params, "prompt": tokens, "tokens": toks,
            "generate_calls": 2,            # the warm-up and the timed call
            "seconds": dt,
            "tok_per_s": args.batch * args.gen / max(dt, 1e-9)}


def main(argv=None) -> Dict[str, Any]:
    """Parse ``argv`` and serve; returns what was served (the engine,
    requests and images, or the LM, prompt and tokens) and its times."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=("gan", "lm"), default="gan")
    ap.add_argument("--mix", choices=sorted(SERVE_MIXES), default="edge-heavy")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "gan":
        return _run_gan(args, device)
    return _run_lm(args, device)


if __name__ == "__main__":
    main()
