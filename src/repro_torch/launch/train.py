"""Training launcher (port of ``repro.launch.train``; the same arguments
and lines, plus ``--device``): the fault-tolerant ``Trainer`` over a
(smoke or full) model with random weights and ``SyntheticLM`` batches,
with restart-exact resume from ``--ckpt-dir``, periodic async
checkpoints and heartbeats.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \\
      --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Without ``--device`` it runs on the card and raises without one;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import functools

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.train.loop import Trainer, TrainState, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", choices=("adamw", "adafactor"),
                    default="adamw")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    spec = get(args.arch)
    mc = spec.smoke if args.smoke else spec.model
    device = resolve_device(args.device)
    opt = (adamw(moment_dtype=torch.bfloat16) if args.optimizer == "adamw"
           else adafactor(stack_of=functools.partial(M.stacked_name, mc)))
    lr = warmup_cosine(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                       total_steps=args.steps)
    step_fn = make_train_step(mc, opt, lr, microbatches=args.microbatches)
    src = SyntheticLM(
        vocab=mc.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, pos_dims=mc.pos_dims,
        frontend_dim=mc.frontend_dim if mc.input_kind == "embeddings"
        else None)
    model = M.init_params(mc, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    params = dict(model.named_parameters())
    state = TrainState(params=model, opt_state=opt.init(params))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(step_fn=step_fn, source=src, ckpt=ckpt,
                      ckpt_every=args.ckpt_every, device=device)
    if ckpt is not None:
        state = trainer.restore_or_init(state)
    state, history = trainer.run(state, args.steps)
    print(f"[train] done at step {state.step}; "
          f"loss {history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
