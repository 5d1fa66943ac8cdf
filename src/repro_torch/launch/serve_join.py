"""Join-serving launcher (port of ``repro.launch.serve_join``): the
``JoinService`` admission front end under synthetic multi-tenant traffic.

Loads one ``JoinEngine`` tenant per regime on the CUDA card, warms the
wave-size bucket ladder, then serves a shuffled stream of per-request
operating points (mixed θ / quant / size) — reporting throughput,
admission latency, occupancy, the kernel-library builds across the
serving phase (flat after warmup), and each tenant's recall and soundness
against the exact NLJ of every request:

  PYTHONPATH=src python -m repro_torch.launch.serve_join --tenants 2 \\
      --requests 24 --quants off,sq8 --metrics-json serve_metrics.json

``--device cpu`` runs the plain PyTorch versions instead of the kernels;
``--shards N --method nlj`` shards every tenant (``--device cpu,cpu
--shards 2``: two shards on the CPU).
The exit code is 0 when every tenant's pairs are sound and no kernel
build happened while serving.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.vectorjoin import preset
from repro_torch.core import exact_join_pairs
from repro_torch.core.types import QUANT_MODES
from repro_torch.data.vectors import make_dataset, thresholds
from repro_torch.launch.join import check_shards, devices_arg, shards_arg
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import JoinRequest, JoinService, ServiceConfig

_REGIMES = ("manifold", "clustered", "weak", "ood")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenant engines to load (one regime each, "
                         f"cycling {_REGIMES})")
    ap.add_argument("--requests", type=int, default=24,
                    help="total requests across tenants")
    ap.add_argument("--n-data", type=int, default=4_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--theta-q", type=int, default=2,
                    help="1-based index into each tenant's 7 thresholds")
    ap.add_argument("--method", default="es_sws",
                    choices=("index", "es", "es_hws", "es_sws", "nlj"))
    ap.add_argument("--quants", default="off,sq8",
                    help="comma-separated quant modes cycled across "
                         f"requests (from {QUANT_MODES})")
    ap.add_argument("--buckets", default="64,128,256",
                    help="comma-separated ascending wave-size ladder")
    ap.add_argument("--plan", choices=("manual", "auto"), default="manual",
                    help="auto: submit requests with method/quant "
                         "unspecified so each is planned at admission by "
                         "its tenant engine's cost table "
                         "(JoinEngine.plan_request), which only resolves "
                         "to operating points the warmup already ran")
    ap.add_argument("--max-request", type=int, default=192,
                    help="request sizes are drawn from [1, max-request]")
    ap.add_argument("--shards", type=shards_arg, default=1,
                    help="shard every tenant's data side over N devices "
                         "('auto' = one shard per device; see --device); "
                         "sharded serving requires --method nlj")
    ap.add_argument("--max-queue", type=int, default=1024)
    ap.add_argument("--max-tenants", type=int, default=8)
    ap.add_argument("--no-interleave", action="store_true",
                    help="serialize per-request submit instead of the "
                         "cross-batch wave interleave (the "
                         "REPRO_SERVE_INTERLEAVE env var overrides)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the bucket-ladder warmup")
    ap.add_argument("--no-truth", action="store_true",
                    help="skip the exact-join recall check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-dump", action="store_true",
                    help="print the service registry in Prometheus "
                         "exposition format after the run")
    ap.add_argument("--metrics-json", metavar="OUT.json", default=None,
                    help="write the metrics snapshot (serve_join.* "
                         "gauges/histograms, engine counters, kernel "
                         "builds) as JSON")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="TraceKit span capture of the serving rounds "
                         "(load at ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card), or a "
                         "comma-separated list of devices, one a shard")
    args = ap.parse_args(argv)

    quants = tuple(q.strip() for q in args.quants.split(",") if q.strip())
    for q in quants:
        if q not in QUANT_MODES:
            ap.error(f"unknown quant mode {q!r}")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    device, mesh = devices_arg(args.device)
    check_shards(ap, args.shards, device, mesh)
    if args.shards != 1 and args.method != "nlj":
        ap.error("--shards: sharded serving supports --method nlj only "
                 "(search methods need the whole graph resident)")
    engine_kw = {"device": device}
    if args.shards != 1:
        engine_kw.update(n_shards=args.shards, mesh=mesh)

    trace_path = args.trace or (
        (obs_trace.env_trace_path() or "trace.json")
        if obs_trace.env_trace_enabled() else None)
    if trace_path:
        tracer = obs_trace.enable()

    svc = JoinService(ServiceConfig(
        buckets=buckets, max_queue=args.max_queue,
        max_tenants=args.max_tenants,
        interleave=not args.no_interleave))
    base = preset(args.method, theta=1.0)

    rng = np.random.default_rng(args.seed)
    tenants: dict[str, tuple] = {}
    for i in range(args.tenants):
        regime = _REGIMES[i % len(_REGIMES)]
        name = f"{regime}-{i}"
        ds = make_dataset(regime, n_data=args.n_data,
                          n_query=args.max_request, dim=args.dim,
                          seed=args.seed + i)
        theta = float(thresholds(ds, 7)[args.theta_q - 1])
        svc.load(name, ds.Y, default=base, engine_kw=engine_kw)
        tenants[name] = (ds, theta)

    t0 = time.perf_counter()
    n_warm = 0
    # planner-routed requests resolve to the engine-default quant when
    # the cost table has nothing cheaper: warm that point too
    warm_quants = (tuple(dict.fromkeys(quants + (base.quant,)))
                   if args.plan == "auto" else quants)
    if not args.no_warmup:
        for name, (ds, theta) in tenants.items():
            n_warm += svc.warmup(name, thetas=[theta],
                                 methods=(args.method,),
                                 quants=warm_quants)
    t_warm = time.perf_counter() - t0
    c_warm = obs_metrics.compile_count()
    print(f"[serve_join] {len(tenants)} tenants "
          f"(|Y|={args.n_data} d={args.dim}), ladder={buckets}, "
          f"warmup: {n_warm} joins in {t_warm:.2f}s "
          f"({c_warm} kernel builds)")

    names = list(tenants)
    reqs = []
    for uid in range(args.requests):
        name = names[int(rng.integers(len(names)))]
        ds, theta = tenants[name]
        n = int(rng.integers(1, args.max_request + 1))
        lo = int(rng.integers(0, args.max_request - n + 1))
        if args.plan == "auto":
            reqs.append(JoinRequest(
                uid=uid, tenant=name,
                X=np.asarray(ds.X, np.float32)[lo:lo + n], theta=theta))
        else:
            reqs.append(JoinRequest(
                uid=uid, tenant=name,
                X=np.asarray(ds.X, np.float32)[lo:lo + n], theta=theta,
                method=args.method, quant=quants[uid % len(quants)]))
    for r in reqs:
        svc.submit(r)

    c0 = obs_metrics.compile_count()
    t0 = time.perf_counter()
    done = svc.run()
    dt = time.perf_counter() - t0
    c1 = obs_metrics.compile_count()

    served = [sj for sj in done.values() if sj.ok]
    n_q = sum(len(r.X) for r in reqs if r.uid in done and done[r.uid].ok)
    n_pairs = sum(len(sj.pairs) for sj in served)
    h = svc.metrics.get("serve_join.admission_seconds")
    admit_mean = h.sum / max(h.count, 1)
    occ = svc.metrics.get("serve_join.occupancy")
    print(f"[serve_join] served {len(served)}/{len(reqs)} requests "
          f"({n_q} queries, {n_pairs} pairs) in {dt:.2f}s "
          f"({n_q / max(dt, 1e-9):.0f} q/s), "
          f"rejected={svc.stats['rejected']}")
    print(f"[serve_join] admission latency mean={admit_mean * 1e3:.1f}ms, "
          f"occupancy mean={occ.sum / max(occ.count, 1):.2f}, "
          f"kernel builds during serve: {c1 - c0} "
          f"({'flat' if c1 == c0 else 'REBUILT'})")

    if trace_path:
        obs_trace.disable()
        tracer.export(trace_path)
        print(f"[serve_join] wrote {tracer.n_events} trace events to "
              f"{trace_path}")
    if args.metrics_json:
        snap = svc.metrics_snapshot()
        snap["counters"]["kernels.builds.serve_delta"] = c1 - c0
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"[serve_join] wrote metrics snapshot to "
              f"{args.metrics_json}")
    if args.metrics_dump:
        print(svc.metrics.prometheus_text(), end="")

    ok = True
    if not args.no_truth:
        # recall per request against its own exact join (pairs carry
        # global stream ids; ServedJoin.qid_offset rebases them)
        for name, (ds, theta) in tenants.items():
            eng = svc.engine(name)
            recs, sound = [], True
            for r in reqs:
                sj = done.get(r.uid)
                if r.tenant != name or sj is None or not sj.ok:
                    continue
                tset = set(map(tuple, exact_join_pairs(
                    r.X, eng.Y, theta).tolist()))
                gset = sj.pair_set_local()
                recs.append(len(gset & tset) / max(len(tset), 1))
                sound &= not (gset - tset)
            if recs:
                print(f"[serve_join] tenant {name}: recall "
                      f"mean={np.mean(recs):.4f} sound={sound} "
                      f"({len(recs)} requests)")
                ok &= sound
    return 0 if ok and c1 == c0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
