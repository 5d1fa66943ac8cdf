"""Serving launcher: continuous-batching decode over a (smoke or full)
model with random weights and synthetic requests (port of
``repro.launch.serve``; the same arguments and lines, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
      --smoke --requests 16 --slots 4 --max-new 16

Without ``--device`` it runs on the card and raises without one;
``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.types import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    spec = get(args.arch)
    mc = spec.smoke if args.smoke else spec.model
    if mc.encoder_only:
        print(f"[serve] {args.arch} is encoder-only: no decode path")
        return 0
    device = resolve_device(args.device)
    model = M.init_params(mc, device=device, generator=torch.Generator(
        device=device).manual_seed(args.seed))
    eng = ServeEngine(mc, model, n_slots=args.slots, s_max=args.s_max,
                      temperature=args.temperature, seed=args.seed,
                      device=device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for uid in range(args.requests):
        plen = int(rng.integers(2, args.prompt_len + 1))
        if mc.input_kind == "embeddings":
            prompt = rng.normal(0, 1, (plen, mc.frontend_dim)).astype(
                np.float32)
        else:
            prompt = rng.integers(0, mc.vocab, plen).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    occ = eng.stats["occupancy_sum"] / max(eng.stats["decode_steps"], 1)
    print(f"[serve] {len(done)} requests, {eng.stats['generated']} tokens "
          f"in {dt:.2f}s ({eng.stats['generated'] / dt:.1f} tok/s), "
          f"decode steps {eng.stats['decode_steps']}, occupancy {occ:.2f}")
    for uid in sorted(done)[:4]:
        print(f"  uid={uid}: {done[uid][:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
