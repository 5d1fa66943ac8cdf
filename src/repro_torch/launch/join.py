"""Vector-join launcher (port of ``repro.launch.join``: every method and
every quant mode, shards, streaming, sweeps, planned operating points,
traces and metric dumps).

Runs one of the paper's methods (the exact ``nlj``; the search path
``index``, ``es``, ``es_hws``, ``es_sws``; the merged-index ``es_mi``,
``es_mi_adapt``) on a synthetic Table-1-regime dataset through a
``JoinEngine`` on the CUDA card and checks the result against the exact
NLJ. ``--stream B`` feeds the queries as streaming batches of B through
``engine.submit`` (carrying the work-sharing cache between batches);
``--sweep`` reruns every Table-2 threshold against the same cached index;
``--plan auto`` lets the engine's planner pick the operating point;
``--trace`` writes a Perfetto trace and ``--metrics-dump`` prints the
engine's registry in the Prometheus text format:

  PYTHONPATH=src python -m repro_torch.launch.join --method es_mi_adapt \\
      --regime ood --n-data 20000 --n-query 500 --theta-q 2 --quant pdx8

``--shards N`` splits the data side into N shards (the MI methods and
nlj), one a device of ``--device`` when it lists several (``--device
cpu,cpu --shards 2``: two shards on the CPU; ``cuda:0,cuda:0``: two on one
card), else one a visible CUDA device; ``--distributed`` (or ``--shards
auto``) takes one shard a device. ``--device cpu`` runs the plain PyTorch
versions instead of the kernels. All f32 matrix products are full IEEE
f32 (TF32 off).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.vectorjoin import (ENGINE_PRESETS, make_engine,
                                           preset)
from repro_torch.core import exact_join_pairs
from repro_torch.core.distributed import DeviceMesh, visible_devices
from repro_torch.core.types import (METHODS, QUANT_MODES, pair_keys,
                                    resolve_device)
from repro_torch.data.vectors import make_dataset, thresholds
from repro_torch.obs import trace as obs_trace


def shards_arg(v: str) -> int:
    """``--shards``: ``auto`` = one shard a device (0, the engine's auto
    sentinel), otherwise a positive int."""
    if v.strip().lower() == "auto":
        return 0
    return int(v)


def devices_arg(spec: str | None):
    """``--device``: one torch device (``None`` = the card), or a
    comma-separated list that becomes a ``DeviceMesh`` over them. Returns
    ``(device, mesh or None)``; the device is the list's first."""
    if spec is None or "," not in spec:
        return resolve_device(spec), None
    mesh = DeviceMesh.of([resolve_device(d.strip())
                          for d in spec.split(",") if d.strip()])
    return mesh.devices[0], mesh


def check_shards(ap: argparse.ArgumentParser, n_shards: int, device,
                 mesh: DeviceMesh | None) -> None:
    """Fail at the launcher with a clear message when more shards are
    asked for than there are devices (the ``--device`` list's, else the
    visible CUDA devices, one on the CPU)."""
    nd = mesh.size if mesh is not None else visible_devices(device)
    if n_shards > nd:
        ap.error(f"--shards {n_shards}: only {nd} device(s) visible; use "
                 f"--shards auto, or list one device per shard with "
                 f"--device (for example --device cpu,cpu or "
                 f"cuda:0,cuda:0; several shards may share a device)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", choices=METHODS, default="es_mi_adapt")
    ap.add_argument("--regime", default="manifold",
                    choices=("manifold", "weak", "clustered", "ood"))
    ap.add_argument("--n-data", type=int, default=20_000)
    ap.add_argument("--n-query", type=int, default=1_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--theta", type=float)
    ap.add_argument("--theta-q", type=int, default=1,
                    help="1-based index into the 7 Table-2-style thresholds")
    ap.add_argument("--wave", type=int, default=256)
    ap.add_argument("--quant", choices=QUANT_MODES, default=None,
                    help="compressed storage: sq8 traverses int8 codes on "
                         "certified bounds and re-ranks the ambiguous band "
                         "in exact f32; sketch8 adds a 1-bit sketch prune "
                         "above int8; pdx8 swaps int8 for the PDX tier, "
                         "whose kernels exit mid-vector on certified tail "
                         "bounds; sketchpdx8 stacks the sketch above it "
                         "(default: the engine spec's mode)")
    ap.add_argument("--early-exit", choices=("on", "off"), default="on",
                    help="PDX modes: retire lanes mid-vector on the "
                         "certified tail bound (pairs identical either "
                         "way; REPRO_EARLY_EXIT overrides both)")
    ap.add_argument("--quant-build", choices=QUANT_MODES, default=None,
                    help="drive the offline index builds through the int8 "
                         "tier of the mode too: identical edges, f32 only "
                         "for the ambiguous band; a mode without an int8 "
                         "tier builds in f32 (default: the engine spec's "
                         "mode)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the strictly sequential wave loop (pair sets "
                         "are identical either way)")
    ap.add_argument("--plan", choices=("manual", "auto"), default="manual",
                    help="auto: let the engine's JoinPlanner pick the "
                         "operating point (method, quant, wave bucket, "
                         "cap seeds) from its LSH selectivity estimate "
                         "and calibrated cost table; --method/--quant "
                         "become defaults, not pins (the pairs are those "
                         "of the hand-tuned knobs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine-spec", default="default",
                    help="EngineSpec preset (default|ci|serving_sketch8)")
    ap.add_argument("--shards", type=shards_arg, default=1,
                    help="shard the data side over N devices (MI and nlj "
                         "methods); 'auto' (or 0) = one shard per device. "
                         "The MeshPlan may re-split shards over a second "
                         "dimension axis for nlj (hybrid dimension+vector "
                         "partitioning)")
    ap.add_argument("--distributed", action="store_true",
                    help="alias for --shards 0 (every device)")
    ap.add_argument("--stream", type=int, default=0, metavar="B",
                    help="submit queries as streaming batches of B")
    ap.add_argument("--sweep", action="store_true",
                    help="rerun all 7 thresholds on the cached index")
    ap.add_argument("--no-truth", action="store_true",
                    help="skip the exact NLJ ground truth (big inputs)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="record per-wave spans and export a Chrome/"
                         "Perfetto trace (load at ui.perfetto.dev). The "
                         "REPRO_TRACE env var also enables tracing: 1/on "
                         "traces to trace.json, any other value is the "
                         "output path")
    ap.add_argument("--metrics-dump", action="store_true",
                    help="print the engine's metrics registry in "
                         "Prometheus exposition format after the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card), or a "
                         "comma-separated list of devices, one a shard")
    args = ap.parse_args(argv)

    device, mesh = devices_arg(args.device)
    n_shards = 0 if args.distributed else args.shards
    check_shards(ap, n_shards, device, mesh)
    ds = make_dataset(args.regime, n_data=args.n_data, n_query=args.n_query,
                      dim=args.dim, seed=args.seed)
    grid = [float(t) for t in thresholds(ds, 7)]
    theta = args.theta or grid[args.theta_q - 1]
    spec = ENGINE_PRESETS[args.engine_spec]
    quant = args.quant or spec.quant
    quant_build = (args.quant_build if args.quant_build is not None
                   else spec.quant_build)
    cfg = preset(args.method, theta=theta,
                 early_exit=args.early_exit == "on")
    cfg = dataclasses.replace(cfg, wave_size=args.wave, quant=quant,
                              overlap=not args.no_overlap)
    eng = make_engine(ds.Y, args.engine_spec, default=cfg, device=device,
                      mesh=mesh, n_shards=n_shards, quant_build=quant_build)
    if args.plan == "auto":
        # the planner picks method/quant/wave from the LSH estimate (the
        # cost table is empty on a cold launcher, so the selectivity
        # heuristic decides); caps stay overflow-checked, so the pairs
        # cannot change
        cfg = eng.plan_config(ds.X, cfg)
        quant = cfg.quant
        # the sticky plan plan_config just made
        plan = eng.planner.plan(
            ds.X, theta=theta, pool_cap=int(cfg.traversal.pool_cap),
            n_shards=eng.n_shards, dim=args.dim)
        print(f"[join] plan auto: method={cfg.method} quant={cfg.quant} "
              f"wave={cfg.wave_size} rerank_cap={plan.rerank_cap} "
              f"merge_cap={plan.merge_cap} mesh={plan.mesh_kind} "
              f"predicted_pairs={plan.predicted_join_size:.0f} "
              f"source={plan.source}")
    if (args.stream and eng.n_shards > 1
            and cfg.method not in ("nlj", "es_mi", "es_mi_adapt")):
        ap.error(f"--stream with --shards supports nlj/es_mi/es_mi_adapt, "
                 f"not {cfg.method}")

    trace_path = args.trace or (
        (obs_trace.env_trace_path() or "trace.json")
        if obs_trace.env_trace_enabled() else None)
    if trace_path:
        tracer = obs_trace.enable()
    print(f"[join] {args.regime} |X|={args.n_query} |Y|={args.n_data} "
          f"dim={args.dim} θ={theta:.4f} method={cfg.method} "
          f"device={device} shards={eng.n_shards} quant={quant} "
          f"quant_build={quant_build} "
          f"overlap={'off' if args.no_overlap else 'on'}")

    t0 = time.perf_counter()
    if args.stream:
        parts = [eng.submit(ds.X[b0:b0 + args.stream], cfg)
                 for b0 in range(0, args.n_query, args.stream)]
        pairs = np.concatenate([r.pairs for r in parts], axis=0)
        n_dist = sum(r.stats.n_dist for r in parts)
        dt = time.perf_counter() - t0
        print(f"[join] {len(parts)} streamed batches: {len(pairs)} pairs "
              f"in {dt:.2f}s (n_dist={n_dist})")
    else:
        res = eng.join(ds.X, cfg)
        dt = time.perf_counter() - t0
        extra = (f", rerank={res.stats.n_rerank}, "
                 f"quant_bytes={res.stats.quant_bytes}"
                 if quant != "off" else "")
        if quant == "sketch8":
            pruned = res.stats.n_dist - res.stats.n_esc8
            extra += (f", esc8={res.stats.n_esc8}, sketch_pruned={pruned}"
                      f" ({pruned / max(res.stats.n_dist, 1):.0%})")
        if quant in ("pdx8", "sketchpdx8"):
            extra += f", dims_frac={res.stats.dims_scanned_frac:.3f}"
        print(f"[join] {len(res.pairs)} pairs in {dt:.2f}s "
              f"(n_dist={res.stats.n_dist}, ood={res.stats.n_ood}, "
              f"builds={eng.n_index_builds}{extra})")
        pairs = res.pairs

    if args.sweep:
        for i, th in enumerate(grid):
            t0 = time.perf_counter()
            r = eng.join(ds.X, cfg, theta=th)
            print(f"[sweep] θ{i + 1}={th:.4f}: {len(r.pairs)} pairs in "
                  f"{time.perf_counter() - t0:.2f}s "
                  f"(builds={eng.n_index_builds})")

    if trace_path:
        obs_trace.disable()
        tracer.export(trace_path)
        print(f"[join] wrote {tracer.n_events} trace events to "
              f"{trace_path} (load at ui.perfetto.dev)")
    if args.metrics_dump:
        print(eng.metrics.prometheus_text(), end="")

    if not args.no_truth:
        truth = exact_join_pairs(ds.X, eng.Y, theta)
        got = pair_keys(pairs, args.n_data)
        tset = pair_keys(truth, args.n_data)
        rec = np.intersect1d(got, tset).size / max(tset.size, 1)
        sound = np.setdiff1d(got, tset).size == 0
        print(f"[join] recall={rec:.4f} sound={sound} truth={tset.size}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
