"""Serve a small assigned-architecture LM on the PyTorch port: prefill a
batch of prompts, then decode continuations greedily with a bounded KV
or recurrent cache.

The twin of ``examples/serve_lm.py`` (recurrentgemma-2b's smoke config,
batch 4, prompts of 96 Zipf tokens, 24 generated tokens). The decode
loop keeps each token on the device and copies the continuations to the
host once at the end.

    python examples/torch_serve_lm.py --arch recurrentgemma-2b
    python examples/torch_serve_lm.py --device cpu

``--device`` defaults to ``cuda``; asking for it on a machine without
CUDA raises. ``main(argv)`` returns what it printed.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.tokens import zipf_tokens  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


def _cache_tensors(cache) -> list:
    """The cache's tensors (its length is a Python int)."""
    if isinstance(cache, dict):
        cache = list(cache.values())
    if isinstance(cache, (list, tuple)):
        return [x for c in cache for x in _cache_tensors(c)]
    return [cache] if isinstance(cache, torch.Tensor) else []


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    cfg = get_smoke_config(args.arch)
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                       device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(zipf_tokens(
        rng, args.batch * args.prompt_len, cfg.vocab).reshape(
        args.batch, args.prompt_len), device=device)

    t0 = time.time()
    logits, cache = T.prefill(cfg, params, prompts, margin=args.gen + 16)
    sync()
    t_prefill = time.time() - t0
    tensors = _cache_tensors(cache)
    mib = sum(x.numel() * x.element_size() for x in tensors) / 2 ** 20
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill:.2f}s; "
          f"cache entries: {len(tensors)} tensors, {mib:.1f} MiB")

    cur = torch.argmax(logits, -1).to(torch.int32)
    generated = [cur]
    t0 = time.time()
    for _ in range(args.gen - 1):
        logits, cache = T.decode_step(cfg, params, cur, cache)
        cur = torch.argmax(logits, -1).to(torch.int32)
        generated.append(cur)
    toks = torch.stack(generated, 1).cpu().numpy()
    dt = time.time() - t0
    tok_s = args.batch * (args.gen - 1) / max(dt, 1e-9)
    print(f"decoded {args.gen} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({tok_s:.1f} tok/s on {device.type})")
    print("continuations:", toks[:, :10].tolist())
    return {"arch": args.arch, "prefill_s": t_prefill, "decode_s": dt,
            "decode_tok_per_s": tok_s, "cache_tensors": len(tensors),
            "cache_mib": mib, "tokens": toks,
            "last_logits": logits.float().cpu().numpy()}


if __name__ == "__main__":
    main()
