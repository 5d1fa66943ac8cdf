"""Learning-rate schedules (port of ``repro.optim.schedule``): pure
functions of the step counter, computed on the host in f32 as the
reference computes them."""
from __future__ import annotations

import numpy as np


def warmup_cosine(*, peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr_frac: float = 0.1):
    """Linear warmup from 0 at step 0, then cosine decay to
    ``end_lr_frac * peak_lr`` at ``total_steps``. ``lr(step)`` returns a
    Python float holding the f32 value."""
    f32 = np.float32
    lo = f32(end_lr_frac * peak_lr)
    amp = f32((1 - end_lr_frac) * peak_lr * 0.5)

    def lr(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        frac = np.clip((step - f32(warmup_steps))
                       / f32(max(total_steps - warmup_steps, 1)),
                       f32(0), f32(1))
        return float(lo + amp * (f32(1) + np.cos(f32(np.pi) * frac)))

    return lr
