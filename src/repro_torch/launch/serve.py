"""Serving launcher of the PyTorch port (port of ``repro.launch.serve``):
batched prefill, then greedy or sampled decode, for any ``--arch`` of
``configs.list_archs()``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
      --smoke --batch 4 --prompt-len 64 --gen 16 --device cpu

``--device`` picks the device (default ``cuda``; asking for it on a
machine without CUDA raises). ``--layers N`` cuts the depth to N
layers. The prompts (and a VLM's patch embeddings or a whisper
encoder's frames) come from ``np.random.default_rng(seed)``, as in the
reference; the weights from a ``torch.Generator`` seeded with ``seed``
on the device, unless ``main`` is given ``params``.

The decode tail is a loop on the host that reads nothing back from the
card per token: the cache's length is a Python int, the next token
stays on the card (argmax, or a Gumbel-max draw from a device
generator at ``--temperature``), and the tokens are copied to the host
once at the end.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as T


def decode_tail(cfg, params, cur0: torch.Tensor, cache, n: int, *,
                temperature: float = 0.0, gen=None) -> torch.Tensor:
    """``n - 1`` decode steps from the first token ``cur0`` [B]; returns
    the ``n`` tokens [B, n] on the card. Greedy at temperature 0, else a
    Gumbel-max draw (the reference's ``jax.random.categorical``)."""
    toks = [cur0]
    cur = cur0
    for _ in range(n - 1):
        logits, cache = T.decode_step(cfg, params, cur, cache)
        if temperature > 0:
            u = torch.rand(logits.shape, generator=gen,
                           device=logits.device).clamp_(min=1e-20)
            logits = logits / temperature - torch.log(-torch.log(u))
        cur = torch.argmax(logits, -1).to(torch.int32)
        toks.append(cur)
    return torch.stack(toks, 1)


def main(argv=None, params=None):
    """Parse ``argv``, prefill and decode; returns what was served:
    cfg, params, prompts, the extra inputs, the tokens [B, gen] (numpy),
    the prefill logits and the timings."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the LM to this many layers (default: the "
                         "config's depth)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if params is None:
        params = T.init_lm(cfg, gen, device)
    rng = np.random.default_rng(args.seed)
    kwargs = {}
    if cfg.is_encoder_decoder:
        kwargs["enc_frames"] = torch.tensor(rng.normal(
            0, 1, (args.batch, cfg.num_prefix_embeds, cfg.d_model)),
            dtype=torch.float32, device=device)
    elif cfg.frontend == "vision":
        kwargs["prefix_embeds"] = torch.tensor(rng.normal(
            0, 1, (args.batch, cfg.num_prefix_embeds, cfg.d_model)),
            dtype=torch.float32, device=device)
    prompts = torch.tensor(rng.integers(0, cfg.vocab,
                                        (args.batch, args.prompt_len)),
                           dtype=torch.int32, device=device)

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.time()
    logits, cache = T.prefill(cfg, params, prompts, margin=args.gen + 16,
                              **kwargs)
    sync()
    t_prefill = time.time() - t0
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{t_prefill:.2f}s ({args.batch * args.prompt_len / t_prefill:.0f} "
          f"tok/s)")

    cur0 = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.time()
    toks_dev = decode_tail(cfg, params, cur0, cache, args.gen,
                           temperature=args.temperature, gen=gen)
    sync()
    t_dec = time.time() - t0
    toks = toks_dev.cpu().numpy()
    print(f"[serve] decoded {args.gen} tokens/seq: {t_dec:.2f}s "
          f"({args.batch * max(args.gen - 1, 1) / max(t_dec, 1e-9):.0f} "
          "tok/s)")
    print(f"[serve] sample continuation (seq 0): {toks[0][:16].tolist()}")
    return {"cfg": cfg, "params": params, "prompts": prompts,
            "inputs": kwargs, "tokens": toks, "prefill_logits": logits,
            "prefill_s": t_prefill, "decode_s": t_dec,
            "prefill_tok_per_s": args.batch * args.prompt_len / t_prefill,
            "decode_tok_per_s": (args.batch * max(args.gen - 1, 1)
                                 / max(t_dec, 1e-9))}


if __name__ == "__main__":
    main()
