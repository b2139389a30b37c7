"""Learning-rate schedules as step -> lr callables (port of
``repro.optim.schedules``). Steps are Python ints; the arithmetic is
float32, as the reference computes it on its float32 step, and the lr
comes back as a Python float."""
from __future__ import annotations

import numpy as np

f32 = np.float32


def constant(lr: float):
    return lambda step: float(f32(lr))


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    from ``peak_lr`` down to ``final_frac * peak_lr`` at
    ``total_steps``."""
    def fn(step):
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        prog = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(peak_lr) * (f32(final_frac) + f32(1 - final_frac) * f32(0.5)
                              * (f32(1) + np.cos(f32(np.pi) * prog)))
        return float(cos)
    return fn


def linear_decay(peak_lr: float, total_steps: int):
    def fn(step):
        frac = f32(1.0) - f32(step) / f32(max(total_steps, 1))
        return float(f32(peak_lr) * np.clip(frac, f32(0.0), f32(1.0)))
    return fn
