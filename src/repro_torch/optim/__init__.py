"""Optimizers and LR schedules (port of ``repro.optim``)."""
from repro_torch.optim.adamw import (Optimizer, adafactor, adamw,
                                    clip_by_global_norm)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["Optimizer", "adamw", "adafactor", "clip_by_global_norm",
           "warmup_cosine"]
