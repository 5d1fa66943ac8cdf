#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
  2. hold each kernel against its plain PyTorch version at ragged,
     sub-tile, empty and NO_NODE shapes;
  3. drive the main path — ``make_engine("default").join`` with the default
     ``JoinConfig()`` (es_mi_adapt, quant off, overlap on) — on sift-like
     data (d = 128) at |Y| = 1,000,000, |X| = 10,000; check that every
     pair is sound in float64, that recall against the exact NLJ on the
     card meets the floor, that all three kernels were launched, and that
     overlap off gives the same pairs;
  4. the OOD path: laion-like data (d = 64), |Y| = 200,000, |X| = 2,000,
     where the hybrid BBFS must run (n_ood > 0), with the same checks and
     again all three kernels launched;
  5. time each kernel at the main path's shapes (phase 2's tolerances
     again), and run the OOD path's overlap-off join once more under
     torch.profiler to show how busy the device is. These come last
     because an attached profiler slows every later launch.

It prints the kernel table as one JSON object, then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` as the last line. It
needs the repository's ``src/`` beside it and a CUDA device; without
either it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

MAIN_N_DATA = 1_000_000
MAIN_N_QUERY = 10_000
# recall of the main path measured on an H100 (PERF.md) minus 0.05
MAIN_RECALL_FLOOR = 0.937
OOD_N_DATA = 200_000
OOD_N_QUERY = 2_000
REPS = 25


def log(*a) -> None:
    print(*a, flush=True)


def device_ms(torch, fn, *, reps: int = REPS) -> tuple[float, float]:
    """Device time of one ``fn(rep)`` call in ms, two ways: the CUDA kernel
    time torch.profiler records, summed and divided by ``reps`` (host gaps
    between launches excluded; 0 if the profiler records no device time),
    and the median of CUDA events around each call (host launch overhead
    included, which dominates a kernel of a few microseconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    ts = []
    for i in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(i)
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    return kernel_us(prof, DeviceType) / reps / 1e3, statistics.median(ts)


def kernel_us(prof, DeviceType) -> float:
    """Total device (kernel) time in µs of a torch.profiler run."""
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def timed(torch, fn) -> tuple[float, float]:
    """(ms, event_ms): the profiler's device time where it records one,
    else the CUDA-event median."""
    dev_ms, ev_ms = device_ms(torch, fn)
    return (dev_ms if dev_ms > 0 else ev_ms), ev_ms


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_pairwise(torch, ops, ref, x, y) -> float:
    got = ops.pairwise_sq_dists(x, y)
    want = ref.pairwise_sq_dists(x, y)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"pairwise shape {got.shape} != {want.shape}")
    if want.numel() == 0:
        return 0.0
    # matmul form: cancellation, and a different summation order
    tol = 1e-5 * (ref.sq_norms(x)[:, None] + ref.sq_norms(y)[None, :]) \
        + 1e-5 * want.abs()
    err = (got - want).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"pairwise {tuple(x.shape)}x{tuple(y.shape)}: "
                             f"max err {float(err.max())} beyond tolerance")
    return float(err.max())


def check_rows(torch, got, want, what: str) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what} shape {got.shape} != {want.shape}")
    if want.numel() == 0:
        return 0.0
    if not bool((got.isfinite() == want.isfinite()).all()):
        raise AssertionError(f"{what}: +inf (NO_NODE) slots differ")
    fin = want.isfinite()
    g, w = got[fin], want[fin]
    if w.numel() == 0:
        return 0.0
    tol = 1e-6 * w.abs() + 1e-6 * w.abs().max()
    err = (g - w).abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max err {float(err.max())} beyond "
                             f"tolerance")
    return float(err.max())


class Inputs:
    """Random kernel inputs on the card, from a fixed seed."""

    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device=self.dev).manual_seed(0)

    def rn(self, *s):
        return self.torch.randn(*s, device=self.dev, generator=self.gen)

    def ids(self, B, K, n, frac_none):
        t = self.torch
        i = t.randint(0, n, (B, K), device=self.dev, generator=self.gen,
                      dtype=t.int32)
        drop = t.rand((B, K), device=self.dev, generator=self.gen) < frac_none
        return t.where(drop, -1, i).to(t.int32)


def check_kernels(torch, ops, ref) -> None:
    """Ragged, sub-tile, empty and NO_NODE shapes against the plain
    versions (before the main path, so a broken kernel fails fast)."""
    inp = Inputs(torch)
    rn, ids = inp.rn, inp.ids
    # the last two are the kNN build's block at the main path's width and
    # at the OOD path's (qblock 4096 x dblock 65536)
    for B, N, d in [(0, 5, 8), (4, 0, 8), (5, 7, 0), (1, 1, 1), (3, 5, 7),
                    (129, 257, 3), (200, 1000, 130), (1000, 3000, 33),
                    (4096, 65536, 128), (4096, 65536, 64)]:
        check_pairwise(torch, ops, ref, rn(B, d), rn(N, d))
    for B, K, d in [(0, 4, 8), (3, 0, 8), (5, 3, 0), (1, 1, 1), (3, 5, 7),
                    (7, 9, 130), (33, 65, 64)]:
        x, c = rn(B, d), rn(B, K, d)
        check_rows(torch, ops.rowwise_sq_dists(x, c),
                   ref.rowwise_sq_dists(x, c), f"rowwise {(B, K, d)}")
        v = rn(50, d)
        for frac in (0.0, 0.3, 1.0):
            i = ids(B, K, 50, frac)
            check_rows(torch, ops.gather_sq_dists(v, x, i),
                       ref.gather_sq_dists(v, x, i), f"gather {(B, K, d)}")
    log("[kernels] ragged / empty / NO_NODE shapes agree")


def time_kernels(torch, ops, ref) -> dict:
    """Each kernel at the main path's shapes: agreement with its plain
    version, device time beside its bound, the plain version's time and a
    library call's. Runs after the join phases: once torch.profiler has
    attached to the card, every later launch costs more host time."""
    inp = Inputs(torch)
    rn, ids = inp.rn, inp.ids
    out = {}

    def entry(shape, err, fn, plain, library, nbytes, flops):
        ms, ev = timed(torch, fn)
        bms, by = bound_ms(nbytes, flops)
        return dict(shape=shape, max_abs_err=err, ms=ms, event_ms=ev,
                    plain_ms=timed(torch, plain)[0],
                    library_ms=None if library is None
                    else timed(torch, library)[0],
                    bound_ms=bms, bound_by=by)

    # pairwise at the kNN build's block shape (qblock 4096 x dblock 65536);
    # compute-bound, so the L2-resident inputs do not flatter it
    B, N, d = 4096, 65536, 128
    x, y = rn(B, d), rn(N, d)
    out["pairwise_sq_dists"] = entry(
        f"({B},{d})x({N},{d})", check_pairwise(torch, ops, ref, x, y),
        lambda _: ops.pairwise_sq_dists(x, y),
        lambda _: ref.pairwise_sq_dists(x, y),
        lambda _: torch.cdist(x, y),
        (B * d + N * d + B * N) * 4, 2.0 * B * N * d)
    del x, y

    # rowwise at the mean_nbr_dist block shape (65536 rows x R = 32); the
    # 1 GiB of rows is 20x the L2. The library call is a batched cdist
    # (it returns the distance, not its square)
    B, K, d = 65536, 32, 128
    x, c = rn(B, d), rn(B, K, d)
    out["rowwise_sq_dists"] = entry(
        f"({B},{d})x({B},{K},{d})",
        check_rows(torch, ops.rowwise_sq_dists(x, c),
                   ref.rowwise_sq_dists(x, c), "rowwise main shape"),
        lambda _: ops.rowwise_sq_dists(x, c),
        lambda _: ref.rowwise_sq_dists(x, c),
        lambda _: torch.cdist(x[:, None], c),
        (B * K * d + B * d + B * K) * 4, 3.0 * B * K * d)
    del x, c

    # gather at the traversal's expand shape: a wave of 256 lanes x E·R =
    # 128 candidates over the merged table, about half of them NO_NODE;
    # each repetition reads other random rows, cold as in the traversal
    n_nodes = MAIN_N_DATA + MAIN_N_QUERY
    B, K, d = 256, 128, 128
    v, x = rn(n_nodes, d), rn(B, d)
    idxs = [ids(B, K, n_nodes, 0.5) for _ in range(REPS)]
    n_valid = sum(int((i >= 0).sum()) for i in idxs) / REPS
    out["gather_sq_dists"] = entry(
        f"({n_nodes},{d}) rows, ({B},{K}) ids, {n_valid:.0f} valid",
        max(check_rows(torch, ops.gather_sq_dists(v, x, i),
                       ref.gather_sq_dists(v, x, i), "gather main shape")
            for i in idxs[:3]),
        lambda r: ops.gather_sq_dists(v, x, idxs[r]),
        lambda r: ref.gather_sq_dists(v, x, idxs[r]), None,
        (n_valid * d + B * d + 2 * B * K) * 4, 3.0 * n_valid * d)
    del v, x, idxs
    for name, r in out.items():
        log(f"[kernels] {name} {r['shape']}: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} (events {r['event_ms']:.4f}) "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']}")
    return out


# ---------------------------------------------------------------------------
# phases 3-4: the join paths
# ---------------------------------------------------------------------------

def check_sound(torch, X, Y, pairs, theta: float) -> int:
    """Every emitted pair lies within θ in float64, up to 16 f32 ulps of
    θ² (the f32 distance decided it). Returns the count within that band."""
    if len(pairs) == 0:
        return 0
    th2 = float(np.float32(theta)) ** 2
    band = 0
    for p0 in range(0, len(pairs), 1 << 20):
        p = torch.as_tensor(pairs[p0:p0 + (1 << 20)], device=X.device)
        diff = X[p[:, 0]].double() - Y[p[:, 1]].double()
        d64 = (diff * diff).sum(1)
        if bool((d64 >= th2 * (1 + 16 * 2.0**-24)).any()):
            worst = float(d64.max())
            raise AssertionError(f"unsound pair: float64 distance² {worst} "
                                 f"vs θ² {th2}")
        band += int((d64 >= th2).sum())
    return band


def recalls(found: np.ndarray, truth: np.ndarray, n_data: int, n_query: int,
            cap: int) -> tuple[float, float]:
    """(recall, recall within the pool cap): the second divides by
    Σ_q min(|truth_q|, cap), the most a pool of ``cap`` slots can hold."""
    from repro_torch.core.types import pair_keys
    t = pair_keys(truth, n_data)
    if t.size == 0:
        return 1.0, 1.0
    hit = np.intersect1d(pair_keys(found, n_data), t).size
    per_q = np.bincount(t // n_data, minlength=n_query)
    return hit / t.size, hit / np.minimum(per_q, cap).sum()


def sync_us(torch, n: int = 1000) -> float:
    """Host cost of one traversal-loop check (reduce + device→host bool)."""
    done = torch.zeros(256, dtype=torch.bool, device="cuda")
    bool(done.all())
    t0 = time.perf_counter()
    for _ in range(n):
        bool(done.all())
    return (time.perf_counter() - t0) / n * 1e6


def run_join(torch, ops, name: str, n_data: int, n_query: int,
             theta_idx: int) -> dict:
    from repro_torch.configs.vectorjoin import make_engine
    from repro_torch.core import JoinConfig, exact_join_pairs
    from repro_torch.core.types import pair_keys
    from repro_torch.data.vectors import table1_dataset, thresholds

    t0 = time.perf_counter()
    ds = table1_dataset(name, n_data=n_data, n_query=n_query, seed=0)
    theta = float(thresholds(ds, 7)[theta_idx])
    cfg = dataclasses.replace(JoinConfig(), theta=theta)
    eng = make_engine(ds.Y, "default", default=cfg)       # on the card
    torch.cuda.synchronize()
    log(f"[{name}] |Y|={n_data} |X|={n_query} d={ds.Y.shape[1]} "
        f"θ={theta:.6f} data {time.perf_counter() - t0:.1f}s")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.join(ds.X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    join_s = wall - eng.build_seconds
    st = res.stats
    n_waves = sum(-(-g // cfg.wave_size)
                  for g in (n_query - st.n_ood, st.n_ood))
    log(f"[{name}] build_s={eng.build_seconds:.2f} join_s={join_s:.2f} "
        f"pairs={len(res.pairs)} n_dist={st.n_dist} n_iters={st.n_iters} "
        f"n_ood={st.n_ood} n_overflow={st.n_overflow} waves={n_waves} "
        f"syncs_per_wave={st.n_iters / max(n_waves, 1):.1f} "
        f"ms_per_iter={join_s / max(st.n_iters, 1) * 1e3:.3f} "
        f"peak_mem_GB={peak / 2**30:.2f} launches={launches}")

    pairs = res.pairs
    if (pairs.dtype != np.int64 or pairs.ndim != 2 or pairs.shape[1] != 2
            or not ((0 <= pairs[:, 0]) & (pairs[:, 0] < n_query)
                    & (0 <= pairs[:, 1]) & (pairs[:, 1] < n_data)).all()):
        raise AssertionError(f"{name}: malformed pair array "
                             f"{pairs.dtype} {pairs.shape}")
    X = torch.as_tensor(ds.X, device=eng.Y.device)
    band = check_sound(torch, X, eng.Y, pairs, theta)
    t0 = time.perf_counter()
    truth = exact_join_pairs(X, eng.Y, theta)
    torch.cuda.synchronize()
    nlj_s = time.perf_counter() - t0
    rec, rec_cap = recalls(res.pairs, truth, n_data, n_query,
                           cfg.traversal.pool_cap)
    log(f"[{name}] sound (boundary band {band}) recall={rec:.6f} "
        f"recall_within_pool_cap={rec_cap:.6f} truth={len(truth)} "
        f"nlj_s={nlj_s:.2f}")

    # the same join with overlap off, on the cached index: identical pairs
    seq_cfg = dataclasses.replace(cfg, overlap=False)
    t0 = time.perf_counter()
    seq = eng.join(ds.X, seq_cfg)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    if not np.array_equal(pair_keys(seq.pairs, n_data),
                          pair_keys(res.pairs, n_data)):
        raise AssertionError(f"{name}: overlap on/off pair sets differ")
    log(f"[{name}] overlap on join_s={join_s:.2f} off join_s={seq_s:.2f} "
        f"(identical pairs)")
    return dict(recall=rec, launches=launches, n_ood=st.n_ood,
                build_s=eng.build_seconds, join_s=join_s, seq_s=seq_s,
                eng=eng, X=ds.X, cfg=seq_cfg, name=name)


def check_launched(run: dict) -> None:
    """Every kernel was launched during the run's join (build included)."""
    missing = [k for k, n in run["launches"].items() if n == 0]
    if missing:
        raise AssertionError(f"{run['name']} path never launched {missing}")


def profile_join(torch, run: dict) -> None:
    """The overlap-off join once more under torch.profiler (device kernels
    only): device busy time against the unprofiled wall time of the same
    join, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    name = run["name"]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run["eng"].join(run["X"], run["cfg"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"[{name}] profiled overlap-off join: device busy {busy:.3f}s; "
        f"unprofiled wall {run['seq_s']:.2f}s (busy share "
        f"{busy / run['seq_s']:.3f}); profiled wall {wall:.2f}s; "
        f"{sum(e.count for e in rows)} device ops")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[{name}]   {e.self_device_time_total / 1e6:8.3f}s "
            f"x{e.count:<8d} {e.key[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core.types import resolve_device
    from repro_torch.kernels import _build, ops, ref

    resolve_device(None)                     # the card, TF32 off
    t_all = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} card {smi}")

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds}s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    check_kernels(torch, ops, ref)
    log(f"[sync] one loop check (reduce + device→host bool) "
        f"{sync_us(torch):.1f} µs")

    main_run = run_join(torch, ops, "sift-like", MAIN_N_DATA, MAIN_N_QUERY, 1)
    if main_run["recall"] < MAIN_RECALL_FLOOR:
        raise AssertionError(f"main path recall {main_run['recall']} below "
                             f"the floor {MAIN_RECALL_FLOOR}")
    check_launched(main_run)
    del main_run["eng"]                       # free the 1M-row index

    ood_run = run_join(torch, ops, "laion-like", OOD_N_DATA, OOD_N_QUERY, 2)
    if ood_run["n_ood"] <= 0:
        raise AssertionError("OOD phase flagged no query: the hybrid BBFS "
                             "did not run")
    check_launched(ood_run)
    table = time_kernels(torch, ops, ref)
    profile_join(torch, ood_run)

    src = "src/repro_torch/kernels/csrc/distance.cu"
    replaces = {
        "pairwise_sq_dists": "src/repro/kernels/distance.py:54",
        "rowwise_sq_dists": "src/repro/kernels/distance.py:106",
        "gather_sq_dists": "src/repro/kernels/gather_distance.py:47",
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=replaces[k],
                    launches=main_run["launches"][k],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for k, r in table.items()]
    log(f"[done] total {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
