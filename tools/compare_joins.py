#!/usr/bin/env python3
"""Time the port's sketch and PDX joins of one checkout on one card.

    python3 tools/compare_joins.py SRC

``SRC`` is the ``src`` directory of the checkout to time: this
repository's, or a parent commit's unpacked beside it (``git archive
<commit> src | tar -x -C build/parent``), so that two versions are
compared in one run on one card, in turns (parent, change, change,
parent). The joins are the smoke's phases 4b and 5b without their checks:
on ``table1_dataset("sift-like")`` at |Y| = 1,000,000, |X| = 10,000 (θ =
``thresholds(ds, 7)[1]``) the sq8 engine (``EngineSpec(quant="sq8",
quant_build="sq8")``) joins under sq8, then sketch8 and pdx8 on its
merged index; on ``"laion-like"`` at |Y| = 200,000, |X| = 2,000 (θ index
2) under sq8, then sketchpdx8. Each mode joins twice. The first sq8 join
builds the merged index, the first join of another mode its tier store;
their seconds (``JoinEngine.build_seconds``) are subtracted from its join
time, and the second join of each mode (rep 1) builds nothing. The sq8
joins run none of the kernels the sketch and PDX modes add, so they show
what the two checkouts' times differ by without them. Prints
one JSON line a join: the card, seconds, pairs, ``n_dist``, ``n_iters``,
``n_rerank``, the dimensions scanned and the kernel launches. Needs a
CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

RUNS = (("sift-like", 1_000_000, 10_000, 1, ("sq8", "sketch8", "pdx8")),
        ("laion-like", 200_000, 2_000, 2, ("sq8", "sketchpdx8")))
REPS = 2


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("compare_joins: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.configs.vectorjoin import EngineSpec, make_engine
    from repro_torch.core import JoinConfig
    from repro_torch.data.vectors import table1_dataset, thresholds
    from repro_torch.kernels import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for name, n_data, n_query, theta_idx, modes in RUNS:
        ds = table1_dataset(name, n_data=n_data, n_query=n_query, seed=0)
        cfg = dataclasses.replace(
            JoinConfig(), theta=float(thresholds(ds, 7)[theta_idx]))
        eng = make_engine(ds.Y, EngineSpec(quant="sq8", quant_build="sq8"),
                          default=cfg, device="cuda")
        for mode in modes:
            mcfg = dataclasses.replace(eng.default, quant=mode)
            for rep in range(REPS):
                built = eng.build_seconds
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = eng.join(ds.X, mcfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = res.stats
                print(json.dumps(dict(
                    src=str(src), card=card, data=name, mode=mode, rep=rep,
                    join_s=wall - (eng.build_seconds - built),
                    build_s=eng.build_seconds - built, pairs=len(res.pairs),
                    n_dist=st.n_dist, n_iters=st.n_iters,
                    n_rerank=st.n_rerank, n_dims_scanned=st.n_dims_scanned,
                    n_dims_total=st.n_dims_total,
                    launches={k: v for k, v in ops.launch_counts().items()
                              if v})), flush=True)
        del eng, ds
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
