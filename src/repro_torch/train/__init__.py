"""Training step and fault-tolerant training loop (port of
``repro.train``)."""
from repro_torch.train.loop import Trainer, TrainState, make_train_step

__all__ = ["Trainer", "TrainState", "make_train_step"]
