#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, in parallel);
  2. hold each kernel against its plain PyTorch version at ragged,
     sub-tile, empty and NO_NODE shapes, and at the main paths' shapes:
     the f32 kernels (the gather bit-equal to the rowwise kernel over the
     gathered rows, its pair-list entry to it, also from unaligned
     bases; its bf16 entry within the gather's tolerance of its plain
     version, also at d = 2048), the int8 pairwise kernel at the sq8 kNN block
     (4096,128)x(65536,128) and at d = 64, the int8 gather (bit-equal to
     its exact plain version, with groups of 128, 64, 12 and 7 dims and
     unaligned codes) and its pair list, the int8 tier's fused gather
     bounds bit-equal to the torch composition over its d̂, at the
     traversal's shape with half the ids NO_NODE, the top-k merge with
     forced ties on both of its routes (a warp a row up to L = K = 64, a
     block a row past it), the Hamming kernels, the PDX pairwise kernel
     (#10; bit for bit its plain version, exit on and off) and its fused
     certified-bounds entry (#10′; bit for bit ``ref.int8_bounds`` over
     #10's d̂) up to the pdx8 NLJ's block (512,128)x(1M,128), the PDX
     gather, the sketch tier's fused gather bounds (#9′; lb and est bit
     for bit the composition they replaced, on the card, at exact
     checkpoint counts, iso ≠ 1, NO_NODE and ids past the table, and the
     traversal's 256 x 128 ids over the merged codes) and the fused PDX
     band re-rank (#11′; its five outputs bit for bit band_compact → the
     PDX gather → band_scatter, exit on and off, at the (256, 1024) pool
     with cap 128 and 1024 and at ragged pools and slabs), the
     pair-list entry's bit equality with the pairwise
     kernel, the int8 pairwise kernel's bit equality with its exact plain
     version and its error against float64 below the cascade's
     MATMUL_GUARD, the fused int8 bounds kernel's bit equality with the
     torch composition over the int8 d̂, and the fused NLJ count (equal to
     the pairwise kernel's counts; to its plain version but for pairs
     within tolerance of θ²) up to the NLJ block (512,128)x(1M,128);
  3. drive the main path — ``make_engine("default").join`` with the default
     ``JoinConfig()`` (es_mi_adapt, quant off, overlap on) — on sift-like
     data (d = 128) at |Y| = 1,000,000, |X| = 10,000; check that every
     pair is sound in float64, that recall against the exact NLJ on the
     card meets the floor, and that its kernels were launched (its
     overlap-off rerun is cut for time: the OOD path, the search path, the
     streams and the sharded join hold overlap on = off);
  3b. on the same engine: ``ops.nlj_count`` over all 10,000 queries in
     one launch against the exact NLJ's per-query pair counts; then the
     search path — es_sws (building G_Y and G_X), es and index on the
     first SEARCH_CUT queries, and on the first MST_CUT es_sws with
     overlap on and off (identical pairs and cache counters), es_hws and
     es_sws under sq8 (an int8 store over G_Y's rows, no second graph
     build) — each sound, at its recall floor, through its kernels, with
     its n_dist beside es_mi_adapt's;
  3c. the streaming engine on the same engine: es_sws ``submit``ted in
     batches of STREAM_BATCH over the first SEARCH_CUT queries with
     overlap on, then off (identical pairs, n_dist, n_iters, eviction and
     tombstone counts, work-sharing cache and carry window), the same
     batches through one ``submit_many`` (identical again), an nlj batch
     (the exact NLJ of its queries) and an es batch under global ids, and
     es_sws under sq8, whose parents come from the int8 pairwise kernel
     (#6) and whose band cap from the LSH estimate (#8);
  3d. the serving path: ``JoinService`` with two tenants, ``sift`` (the
     main engine's 1M-row card tensor, phase 3b's G_Y installed) and
     ``laion`` (phase 5's data, its G_Y built by its warmup), warmed at
     their θ (es_sws, off and sq8), serving SERVE_REQUESTS requests of 1 to
     SERVE_MAX queries (a quarter at recall budget 0.5, two planned by the
     cost table) and two bad ones (rejected and counted): served = a
     direct ``submit`` replay of the same plans (pairs, ``qid_offset``,
     n_dist, n_iters), every pair sound, recall per tenant and quant at its
     floor, the kernel-build count flat after warmup, ``unload("laion")``
     freeing its G_Y, #3 (and under sq8 #6, #7′, #8) launched per tenant;
     then ``plan_config`` on the main engine and ``python -m
     repro_torch.launch.serve_join --plan auto`` in a process of its own;
  3e. the sharded join on SHARDS logical shards of the card (a
     ``DeviceMesh`` of ``cuda`` four times) over the main engine's card
     tensor: es_mi_adapt in f32 on the first SHARD_CUT queries (the
     per-shard builds; overlap on = off; sound; recall against the exact
     NLJ of those queries at its floor, the unsharded join's beside it),
     sq8 and pdx8 (per-shard stores, #7′, #11′; no overlap-off reruns,
     the smoke's time limit) and the ring label
     (= the all_gather join's pairs) on the same queries, the
     vector-plan mesh NLJ (= the exact NLJ, exactly), a hybrid 2 data x
     4 model plan on ci_hd-shaped data (= the exact NLJ but for pairs
     within 16 ulps of θ; psum traffic metered), sharded ``submit``
     (nlj = the exact NLJ; es_mi = each batch's join shifted by its
     offset), a 4-shard
     ``JoinService`` tenant (nlj requests = their direct replays; an
     es_sws request rejected), ``vector_join`` with a prebuilt merged
     index (= the engine's join), and ``launch.join --shards 4`` in a
     process of its own (``--sharded-only`` runs this phase alone);
  4. the sq8 main path on the same data: ``make_engine(Y,
     EngineSpec(quant="sq8", quant_build="sq8")).join`` — the cascade-driven
     build (its kNN lists must equal the f32 build's but for ties at the
     k-th distance; its mean ms per bound block is logged), the join on
     certified int8 bounds with the exact re-rank of the ambiguous band
     (sound, recall against the f32 NLJ; no overlap-off rerun, as in 3),
     and ``method="nlj"`` under sq8
     (the f32 NLJ's pairs but for counted pairs within 16 f32 ulps of θ);
  5. the OOD path: laion-like data (d = 64), |Y| = 200,000, |X| = 2,000,
     where the hybrid BBFS must run (n_ood > 0), with the same checks and
     overlap off = on, in f32 and under sq8; then sketchpdx8 on the sq8
     engine's index (overlap and early exit off = on), and
     (5c) es_mi_adapt under sq8 streamed in two batches of 1,000, each
     building its own merged index, each equal to ``join`` of its queries
     shifted by its offset;
  5d. the LM serving path, in a process of its own (``--lm-only`` runs
     it alone): gemma2-9b at its published width and depth (42 layers,
     d 3,584, vocab 256,000, local window 4,096) in bf16 with random
     weights from a seeded generator on the card; prefill and one decode
     step against the full forward on a 4,200-token prompt (past the
     window: the local layers' rings wrap) and a short one (within
     LM_TOL, every logit finite); ``ServeEngine`` with LM_SLOTS slots and
     s_max LM_S_MAX serving LM_REQUESTS prompts of 16-512 tokens and the
     4,200-token one, LM_MAX_NEW new tokens each (prefill ms, the median
     decode step at four lanes beside its HBM bound over the lanes' valid
     K/V and over the whole cache, tokens/s, peak memory; the share of
     the first four requests' tokens equal to their solo runs), then the
     first four
     sampled at LM_TEMPERATURE and greedy again (step ms and the token
     choice's ms of each);
     then every decodable smoke config in f32 (decode = forward within
     LM_SMOKE_TOL; two-slot batches = solo runs but for counted flips at
     near-ties; hubert's engine raises ValueError), and ``python -m
     repro_torch.launch.serve --arch gemma2_9b`` in a process of its own.
     It launches none of the eleven kernels;
  5e. the LM training path, in a process of its own (``--train-only``
     runs it alone): ``dot_f32``'s backward on the card = the CPU
     route's; tinyllama-1.1b at its published width and depth (22 layers,
     d 2,048, vocab 32,000) in bf16, random weights from a seeded
     generator on the card, TRAIN_STEPS steps of TRAIN_BATCH × TRAIN_SEQ
     ``SyntheticLM`` tokens in TRAIN_MICRO micro-batches through
     ``Trainer`` (AdamW with bf16 moments, warmup-cosine): every loss
     finite, the last below the first; step ms, tokens/s, peak memory and
     the step's bound (``train_bound_ms``) logged (the smoke's time limit
     left out its profiled step: PERF.md §7); then one step of every smoke
     config in f32 on the card
     = the same step on the CPU (loss, aux, grad norm), and ``python -m
     repro_torch.launch.train --smoke`` twice in processes of their own,
     the second resuming from the first one's checkpoint. It launches
     none of the eleven kernels;
  5f. the LM dry run and the production-mesh training step, in a process
     of its own (``--dryrun-only`` runs it alone): (a) DRYRUN_CELLS
     (tinyllama-1.1b train_4k, prefill_32k, decode_32k and llama3-405b
     train_4k) each through ``python -m repro_torch.launch.dryrun`` on the
     single-pod (32, 8) H100 mesh over a fake 256-rank group, all four
     processes at once (started before phase 5e, for the smoke's time
     limit: they need only the host's CPU, which 5e's device-bound steps
     barely use), each cell's GB per device against 80, its three
     roofline terms, bottleneck, step_s / step_min_s and roofline
     fraction logged (the model's predictions for the H100 spec); (b)
     tinyllama-1.1b at its published width and depth in bf16, phase 5e's
     shape and seed (8 x 2,048 tokens, 2 micro-batches, remat full, AdamW
     with bf16 moments) through ``train.sharded_train_step`` on a (1, 1)
     mesh of a one-rank NCCL group, two steps, each step's loss and grad
     norm = two plain ``make_train_step`` steps' on a model from the same
     seed within DRYRUN_STEP_RTOL (the gap logged); (c) the cost counter on
     (b)'s second step against the fake-tensor dry run of the same cell on
     a (1, 1) mesh: FLOPs equal exactly, the dry run's peak within
     DRYRUN_PEAK_TOL of the first step's ``max_memory_allocated``, the
     measured step ms beside the model's step_min_s. It launches none of
     the eleven kernels;
  5g. the join dry run, in 5f's process: (a) the five join cells
     (``configs.vectorjoin.JOIN_DRYRUN_CELLS``) through ``python -m
     repro_torch.launch.dryrun --join NAME --device cpu`` on the (32, 8)
     mesh, beside 5f's cells, each logged as theirs are; (b) one separated
     iteration of the mesh MI join (``core.distributed.mesh_mi_iteration``:
     probe, one traversal iteration, band compaction, combine) on SHARDS
     logical shards of the main data (per-shard merged indexes over the
     first JOIN_WAVE queries), one wave, in f32 and with bf16 vectors,
     under the cost counter: its FLOPs = SHARDS x the dry run's trace of
     one shard of the same shapes (``launch.dryrun.trace_join_wave``, which
     gives (a)'s rows), #3 (and its bf16 entry) launched, the bf16 entry within
     tolerance of its plain version at the iteration's ids; (c)
     ``make_distributed_nlj_count`` on a (4, 2) mesh of logical shards
     (rows over 4, dims over 2), the first NLJ2D_QUERIES main queries
     against the 1M rows = #5's counts but for pairs within 16 ulps of θ
     (counted and logged);
  6. time each kernel at the main paths' shapes (#3's bf16 entry on a
     bf16 table, #3 also through its custom op), the gathers also at the
     NLJ's pair block (4,194,304 pairs over a 512-query block), #10 and
     #10′ with early exit on and off, #9′ and #11′ beside the eager
     compositions they replaced (#11′ at the pdx8 join's band occupancy),
     every
     CUDA-event median first and the profiler's device times after them
     (phase 2's tolerances again; torch.mm with TF32 off logged beside the
     f32 pairwise kernel as the CUDA cores' ceiling), trace one pair
     block of the NLJ's escalation (``join.escalate_block``, the int8
     tier over 1M random rows) under torch.profiler, and run the OOD
     path's overlap-off join of its first 500 queries under
     torch.profiler to show how busy the device is. These come last
     because an attached profiler slows every later launch.

Every path is driven with the launch counts set to 0 just before it and
read just after; a path that did not launch one of its kernels fails, and
so does a sketch or PDX join that launched a bare entry (#9, #11) its
fused one (#9′, #11′) replaced.
It prints the kernel table as one JSON object, then the card's name and
power limit, then ``{"ok": true, "device": {...}}`` as the last line. It
needs the repository's ``src/`` beside it and a CUDA device; without
either it exits non-zero and prints no result. ``--kernels-only`` stops
after phase 2 (a quick check that the kernels build and agree).
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, int8
# on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

MAIN_N_DATA = 1_000_000
MAIN_N_QUERY = 10_000
# recall of the main path measured on an H100 (PERF.md) minus 0.05
MAIN_RECALL_FLOOR = 0.937
# the search path (phase 3b): es_sws, es and index run on the first
# SEARCH_CUT queries (the smoke's time limit: at full depth es and index
# took 21-23 s each on an H100 and es_sws 79-118 s, the last in a smoke
# of 1,166.8 s, PERF.md); recall floors measured there minus 0.05
SEARCH_CUT = 2_000
# es_sws's overlap on/off identity, es_hws and es_sws under sq8 (phase
# 3b) run on the first MST_CUT queries, over their own G_X, built by the
# first of them: an MST-order join's iterations fall slowly with its
# queries (on an H100, PERF.md: 44,320 for 10,000, 19,844 for 2,000, 7,005
# for 500), and on all 10,000 each of these joins took 70-121 s; on 500
# they took 14.3-16.3 s each in a smoke of 944.2 s with the LM phase 5d
# (past the 900 s that PERF.md keeps as this script's budget)
MST_CUT = 250
SEARCH_RECALL_FLOORS = {"index": 0.935, "es": 0.935, "es_hws": 0.937,
                        "es_sws": 0.937, "es_sws/sq8": 0.912}
# the profiled OOD join runs on the first PROFILE_QUERIES queries
PROFILE_QUERIES = 500
# the NLJ's query block and the pair block its escalation runs in
# (core/join.py: block, pair_block)
NLJ_QBLOCK = 512
PAIR_BLOCK = 1 << 22
OOD_N_DATA = 200_000
OOD_N_QUERY = 2_000
REPS = 25
# kernels each path must launch
F32_KERNELS = ("pairwise_sq_dists", "rowwise_sq_dists", "gather_sq_dists",
               "topk_merge")
SQ8_KERNELS = ("pairwise_bounds_int8", "gather_bounds_int8",
               "topk_merge", "gather_sq_dists", "pairlist_sq_dists")
SQ8_NLJ_KERNELS = ("pairwise_bounds_int8", "gather_sq_dists_pairs")
# the sketch and PDX modes: the merged-index join's kernels, the NLJ's
SKETCH8_KERNELS = ("gather_sketch_bounds", "gather_bounds_int8",
                   "gather_sq_dists")
SKETCH8_NLJ_KERNELS = ("pairwise_hamming", "gather_bounds_int8_pairs",
                       "gather_sq_dists_pairs")
PDX8_KERNELS = ("gather_bounds_int8", "pdx_compact_gather")
PDX8_NLJ_KERNELS = ("pairwise_bounds_pdx", "gather_sq_dists_pairs")
SKETCHPDX8_KERNELS = ("gather_sketch_bounds", "gather_bounds_int8",
                      "pdx_compact_gather")
# the bare entries the fused ones replaced: no launch on those joins
FUSED_AWAY = ("rowwise_hamming", "pdx_gather_sq_dists")
SKETCHPDX8_NLJ_KERNELS = SKETCH8_NLJ_KERNELS
# recall floors of the sketch/PDX joins: measured on an H100 (PERF.md)
# minus 0.05
SKETCH8_RECALL_FLOOR = 0.918
PDX8_RECALL_FLOOR = 0.920
OOD_SKETCHPDX8_RECALL_FLOOR = 0.026

ULP16 = 16 * 2.0**-24      # 16 f32 ulps, relative
DEV = "cuda"


_T0 = time.perf_counter()


def log(*a) -> None:
    """A progress line, stamped with the seconds since the script began."""
    print(f"{time.perf_counter() - _T0:7.1f}s", *a, flush=True)


def event_ms(torch, fn, *, reps: int = REPS) -> float:
    """Median of CUDA events around each of ``reps`` calls ``fn(rep)``,
    after one warm-up call: the per-call cost a caller sees, host launch
    overhead included (which dominates a kernel of a few microseconds).
    Taken before any profiler session: once torch.profiler has attached,
    every later launch costs more host time."""
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
    return statistics.median(ts)


def profiled_ms(torch, fn, *, reps: int = REPS) -> float:
    """Device time of one ``fn(rep)`` call in ms: the CUDA kernel time
    torch.profiler records over ``reps`` calls, divided by ``reps`` (host
    gaps between launches excluded); 0 if it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    return kernel_us(prof, DeviceType) / reps / 1e3


def kernel_us(prof, DeviceType) -> float:
    """Total device (kernel) time in µs of a torch.profiler run."""
    return sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def bound_ms(nbytes: float, flops: float,
             peak_ops: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak_ops * 1e3
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


def unaligned(t):
    """``t``'s values in a contiguous 2-D view whose base is one element
    past an aligned address (the kernels' narrow-load paths)."""
    n, d = t.shape
    buf = t.new_empty(n * d + 1)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(n, d)


def pair_list(torch, idx):
    """A (B, K) id matrix as the pair list (qi = b, yi = idx[b, k])."""
    B, K = idx.shape
    qi = torch.arange(B, device=idx.device, dtype=torch.int32)
    return qi.repeat_interleave(K), idx.reshape(-1).contiguous()


def check_f32_gathers(torch, ops, ref, v, x, idx, what: str) -> float:
    """#3: the gather kernel against its plain version; bit for bit
    against the rowwise kernel (#2) over the gathered rows where both take
    the same load path (the two share each lane's slots, fmaf chain and
    xor-tree), and its pair-list entry bit for bit against it. Returns
    max |kernel − plain|."""
    got = ops.gather_sq_dists(v, x, idx)
    err = check_rows(torch, got, ref.gather_sq_dists(v, x, idx),
                     f"gather {what}")
    if idx.numel() == 0:
        return err
    qi, yi = pair_list(torch, idx)
    if not torch.equal(ops.gather_sq_dists_pairs(v, x, qi, yi),
                       got.reshape(-1)):
        raise AssertionError(f"gather {what}: the pair-list entry differs")
    d = x.shape[1]
    if v.shape[0] and (d % 4 != 0 or (v.data_ptr() % 16 == 0
                                      and x.data_ptr() % 16 == 0)):
        valid = (idx >= 0) & (idx < v.shape[0])
        cands = v[torch.where(valid, idx, 0).long()]
        rw = torch.where(valid, ops.rowwise_sq_dists(x, cands), torch.inf)
        if not torch.equal(rw, got):
            raise AssertionError(f"gather {what}: "
                                 f"{int((rw != got).sum())} values differ "
                                 f"from the rowwise kernel's")
    return err


def check_bf16_gather(torch, ops, ref, v, x, idx, what: str) -> float:
    """#3's bf16 entry against its plain version (bf16 rows and queries
    widened to f32, summed in f32) at the f32 gather's tolerance. Returns
    max |kernel − plain|."""
    return check_rows(torch, ops.gather_sq_dists(v, x, idx),
                      ref.gather_sq_dists(v, x, idx), f"gather bf16 {what}")


def check_int8_gathers(torch, ops, ref, codes, qx, idx, scales, gs: int,
                       err, qerr, what: str) -> float:
    """#7 bit for bit against its exact plain version (per-group integer
    sums, the kernel's f32 steps) and within tolerance of the dequantizing
    one; #7' (both entries, the pair list over the same pairs) bit for bit
    against the torch composition over its d̂. Returns max |kernel −
    dequantizing plain|."""
    kw = dict(group_size=gs)
    got = ops.gather_sq_dists_int8(codes, qx, idx, scales, **kw)
    e = check_int8_rows(torch, got, ref.gather_sq_dists_int8(
        codes, qx, idx, scales, **kw), f"int8 gather {what}")
    if idx.numel() == 0:
        return e
    if not torch.equal(got, ref.gather_sq_dists_int8_exact(
            codes, qx, idx, scales, **kw)):
        raise AssertionError(f"int8 gather {what}: differs from its exact "
                             f"plain version")
    qi, yi = pair_list(torch, idx)
    valid = (idx >= 0) & (idx < codes.shape[0])
    want = ref.gather_bounds(got, qerr[:, None]
                             + err[torch.where(valid, idx, 0).long()])
    lb, ub = ops.gather_bounds_int8(codes, qx, idx, scales, err=err,
                                    qerr=qerr, **kw)
    plb, pub = ops.gather_bounds_int8_pairs(codes, qx, qi, yi, scales,
                                            err=err, qerr=qerr, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(lb, want[0]) and torch.equal(ub, want[1])
            and torch.equal(plb, lb.reshape(-1))
            and torch.equal(pub, ub.reshape(-1))):
        raise AssertionError(f"int8 gather bounds {what}: differ from the "
                             f"composition over the kernel's d̂")
    return e


class Inputs:
    """Random kernel inputs on the card, from a fixed seed."""

    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device(DEV)
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
                    (7, 9, 130), (33, 65, 64), (9, 1, 128), (17, 37, 256)]:
        x, c = rn(B, d), rn(B, K, d)
        check_rows(torch, ops.rowwise_sq_dists(x, c),
                   ref.rowwise_sq_dists(x, c), f"rowwise {(B, K, d)}")
        v = rn(50, d)
        for frac in (0.0, 0.3, 1.0):
            i = ids(B, K, 50, frac)
            check_f32_gathers(torch, ops, ref, v, x, i, f"{(B, K, d)}")
            vb, xb = v.bfloat16(), x.bfloat16()
            check_bf16_gather(torch, ops, ref, vb, xb, i, f"{(B, K, d)}")
            if B and d:
                check_f32_gathers(torch, ops, ref, unaligned(v),
                                  unaligned(x), i, f"{(B, K, d)} unaligned")
                check_bf16_gather(torch, ops, ref, unaligned(vb),
                                  unaligned(xb), i, f"{(B, K, d)} unaligned")
    # the traversal's shape: 256 lanes x 128 ids over the merged table
    n_nodes = MAIN_N_DATA + MAIN_N_QUERY
    check_f32_gathers(torch, ops, ref, rn(n_nodes, 128), rn(256, 128),
                      ids(256, 128, n_nodes, 0.5), "main shape")
    # the bf16 entry there, and at the bf16 join cell's width (d = 2048)
    check_bf16_gather(torch, ops, ref, rn(n_nodes, 128).bfloat16(),
                      rn(256, 128).bfloat16(), ids(256, 128, n_nodes, 0.5),
                      "main shape")
    check_bf16_gather(torch, ops, ref, rn(65536, 2048).bfloat16(),
                      rn(256, 2048).bfloat16(), ids(256, 128, 65536, 0.5),
                      "d = 2048")
    log("[kernels] ragged / empty / NO_NODE / unaligned shapes agree; the "
        "gather bit-equal to the rowwise kernel and its pair list to it; "
        "its bf16 entry within tolerance of its plain version")


def check_int8_pairwise(torch, ops, ref, st, qx, xn) -> float:
    """int8 pairwise kernel bit for bit against its own arithmetic
    (``ref.pairwise_sq_dists_int8_exact``: exact per-group dots, the
    kernel's f32 steps), and against float64 ‖x̂−ŷ‖², whose error the
    certified bounds cover with MATMUL_GUARD·(xn+yn)."""
    from repro_torch.quant.cascade import MATMUL_GUARD
    from repro_torch.quant.store import dequantize
    got = ops.pairwise_sq_dists_int8(qx, st.q, st.scales,
                                     group_size=st.group_size, xn=xn,
                                     yn=st.norms)
    want = ref.pairwise_sq_dists_int8_exact(qx, st.q, st.scales, xn,
                                            st.norms,
                                            group_size=st.group_size)
    torch.cuda.synchronize()
    what = f"int8 pairwise {tuple(qx.shape)}x{tuple(st.q.shape)}"
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if want.numel() == 0:
        return 0.0
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: {int((got != want).sum())} values "
                             f"differ from the exact plain version (max "
                             f"{err})")
    del want
    nsum = xn[:, None] + st.norms[None, :]
    x64 = dequantize(qx, st.scales, st.group_size).double()
    y64 = dequantize(st.q, st.scales, st.group_size).double()
    d64 = ((x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
           - 2.0 * (x64 @ y64.T)).clamp_min(0.0)
    e64 = (got.double() - d64).abs()
    if not bool((e64 < MATMUL_GUARD * nsum.double()).all()):
        raise AssertionError(f"{what}: error against float64 "
                             f"{float(e64.max())} reaches MATMUL_GUARD")
    return err


def check_int8_bounds(torch, ops, ref, st, qx, xn, xe) -> float:
    """The fused bounds kernel (#6') bit for bit against the torch
    composition (``ref.int8_bounds``) over the int8 pairwise kernel's d̂.
    Returns max |Δ| (0)."""
    from repro_torch.quant.cascade import MATMUL_GUARD
    kw = dict(group_size=st.group_size, xn=xn, yn=st.norms)
    lb, ub = ops.pairwise_bounds_int8(qx, st.q, st.scales, xe=xe, ye=st.err,
                                      guard=MATMUL_GUARD, **kw)
    wlb, wub = ref.int8_bounds(ops.pairwise_sq_dists_int8(
        qx, st.q, st.scales, **kw), xn, st.norms, xe, st.err, MATMUL_GUARD)
    torch.cuda.synchronize()
    what = f"int8 bounds {tuple(qx.shape)}x{tuple(st.q.shape)}"
    if lb.shape != wlb.shape or ub.shape != wub.shape:
        raise AssertionError(f"{what}: shapes {lb.shape}/{ub.shape}")
    if lb.numel() == 0:
        return 0.0
    err = max(float((lb - wlb).abs().max()), float((ub - wub).abs().max()))
    if not (torch.equal(lb, wlb) and torch.equal(ub, wub)):
        raise AssertionError(f"{what}: {int((lb != wlb).sum())} lb and "
                             f"{int((ub != wub).sum())} ub values differ "
                             f"from the composition (max {err})")
    return err


def check_int8_rows(torch, got, want, what: str) -> float:
    """int8 rowwise/gather against the plain version: |Δ| ≤ 1e-5·value +
    1e-6, +inf (NO_NODE) slots identical."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{what} shape {got.shape} != {want.shape}")
    if not bool((got.isfinite() == want.isfinite()).all()):
        raise AssertionError(f"{what}: +inf (NO_NODE) slots differ")
    fin = want.isfinite()
    if not bool(fin.any()):
        return 0.0
    err = (got[fin] - want[fin]).abs()
    if not bool((err <= 1e-5 * want[fin].abs() + 1e-6).all()):
        raise AssertionError(f"{what}: max err {float(err.max())} beyond "
                             f"tolerance")
    return float(err.max())


def check_int8_bound_rows(torch, got, want, what: str) -> float:
    """#7' (lb, ub) against its plain version, the composition over the
    dequantizing d̂: +inf (NO_NODE) slots identical, the others within
    ``check_int8_rows``' d̂ tolerance at the scale of ub (a change of d̂
    moves lb by at most itself, and ub by at most ub/d̂ times itself).
    Returns max |kernel − plain| over both."""
    torch.cuda.synchronize()
    err = 0.0
    fin = want[1].isfinite()
    tol = 1e-5 * want[1][fin].abs() + 1e-6
    for g, w, nm in zip(got, want, ("lb", "ub")):
        if g.shape != w.shape:
            raise AssertionError(f"{what} {nm} shape {g.shape} != {w.shape}")
        if not bool((g.isfinite() == w.isfinite()).all()):
            raise AssertionError(f"{what} {nm}: +inf (NO_NODE) slots differ")
        if not bool(fin.any()):
            continue
        e = (g[fin] - w[fin]).abs()
        if not bool((e <= tol).all()):
            raise AssertionError(f"{what} {nm}: max err {float(e.max())} "
                                 f"beyond tolerance")
        err = max(err, float(e.max()))
    return err


def check_topk(torch, ops, ref, bd, bi, cd, ci, what: str) -> None:
    """top-k merge against the plain version: exact, ids and tie order."""
    gd, gi = ops.topk_merge(bd, bi, cd, ci)
    wd, wi = ref.topk_merge(bd, bi, cd, ci)
    torch.cuda.synchronize()
    if not (torch.equal(gd, wd) and torch.equal(gi, wi)):
        bad = int(((gd != wd) | (gi != wi)).any(1).sum())
        raise AssertionError(f"topk_merge {what}: {bad} rows differ")


def topk_inputs(inp, B: int, L: int, K: int):
    """A sorted beam and candidates drawn from few values (forced ties),
    some +inf."""
    t = inp.torch
    g = inp.gen
    bd = t.randint(0, 16, (B, L), device=inp.dev, generator=g).float()
    bd = t.where(t.rand((B, L), device=inp.dev, generator=g) < 0.05,
                 t.inf, bd)
    bd = t.sort(bd, dim=1)[0].contiguous()
    cd = t.randint(0, 16, (B, K), device=inp.dev, generator=g).float()
    cd = t.where(t.rand((B, K), device=inp.dev, generator=g) < 0.05,
                 t.inf, cd).contiguous()
    bi = t.randint(0, 1 << 30, (B, L), device=inp.dev, generator=g,
                   dtype=t.int32)
    ci = t.randint(0, 1 << 30, (B, K), device=inp.dev, generator=g,
                   dtype=t.int32)
    return bd, bi, cd, ci


def check_pairlist(torch, ops, x, y, n_pairs: int, gen) -> None:
    """The pair-list entry reproduces the pairwise kernel's values bit
    for bit on sampled pairs, given the same norm tensors."""
    from repro_torch.kernels import ref
    xn, yn = ref.sq_norms(x), ref.sq_norms(y)
    full = ops.pairwise_sq_dists(x, y, xn=xn, yn=yn)
    qi = torch.randint(0, x.shape[0], (n_pairs,), device=x.device,
                       generator=gen, dtype=torch.int32)
    yi = torch.randint(0, y.shape[0], (n_pairs,), device=x.device,
                       generator=gen, dtype=torch.int32)
    got = ops.pairlist_sq_dists(x, y, qi, yi, xn=xn, yn=yn)
    torch.cuda.synchronize()
    want = full[qi.long(), yi.long()]
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"pairlist {tuple(x.shape)}x{tuple(y.shape)}: "
                             f"{bad} of {n_pairs} pairs differ from the "
                             f"pairwise kernel")


def check_kernels_sq8(torch, ops, ref) -> None:
    """The int8, top-k merge and pair-list kernels against their plain
    versions, at ragged/empty shapes and at the sq8 main path's shapes."""
    from repro_torch.quant.store import build_store, quantize_queries
    inp = Inputs(torch)
    rn, ids = inp.rn, inp.ids
    # int8 pairwise: ragged, empty, d < 128, d % 128 != 0, and the kNN
    # block at d = 128 and d = 64 (the OOD path's width)
    for B, N, d in [(0, 5, 8), (4, 0, 8), (1, 1, 1), (3, 5, 7),
                    (129, 257, 33), (200, 1000, 130), (77, 300, 200),
                    (4096, 65536, 128), (4096, 65536, 64)]:
        st = build_store(rn(N, d) if N else rn(1, d)[:0])
        qx, xn, xe = quantize_queries(rn(B, d), st)
        check_int8_pairwise(torch, ops, ref, st, qx, xn)
        check_int8_bounds(torch, ops, ref, st, qx, xn, xe)
    # int8 rowwise (B, K, d) form, gather form, its pair list and #7',
    # with groups of 128, 64 (PDX slabs), 12 and 7 dimensions, and from an
    # unaligned code table
    for B, K, d in [(0, 4, 8), (3, 0, 8), (1, 1, 1), (3, 5, 7),
                    (7, 9, 130), (33, 65, 64), (16, 40, 200), (9, 1, 128),
                    (5, 33, 0)]:
        for gs in (128, 64, 12, 7):
            st = build_store(rn(50, d), group_size=gs)
            qx, _, qe = quantize_queries(rn(B, d), st)
            qc = st.q[torch.randint(0, 50, (B, K), device=inp.dev,
                                    generator=inp.gen).long()]
            check_int8_rows(torch, ops.rowwise_sq_dists_int8(
                qx, qc, st.scales, group_size=gs),
                ref.rowwise_sq_dists_int8(qx, qc, st.scales, group_size=gs),
                f"int8 rowwise {(B, K, d)} gs {gs}")
            for frac in (0.0, 0.5, 1.0):
                i = ids(B, K, 50, frac)
                for codes in ((st.q, unaligned(st.q)) if d else (st.q,)):
                    check_int8_gathers(torch, ops, ref, codes, qx, i,
                                       st.scales, gs, st.err, qe,
                                       f"{(B, K, d)} gs {gs} "
                                       f"{codes.data_ptr() % 16}")
    # the traversal's shape: 256 lanes x 128 ids over the merged table, in
    # the sq8 (one group) and the pdx8 (two 64-dim slabs) grids
    n_nodes = MAIN_N_DATA + MAIN_N_QUERY
    y = rn(n_nodes, 128)
    for gs in (128, 64):
        st = build_store(y, group_size=gs)
        qx, _, qe = quantize_queries(rn(256, 128), st)
        check_int8_gathers(torch, ops, ref, st.q, qx,
                           ids(256, 128, n_nodes, 0.5), st.scales, gs,
                           st.err, qe, f"main shape gs {gs}")
    del st, y
    # top-k merge: ragged/empty, both routes (the warp kernel up to L = K
    # = 64, the block kernel past it) and the kNN block (4096,48)+(4096,48)
    for B, L, K in [(0, 4, 4), (3, 0, 5), (5, 4, 0), (1, 1, 1), (7, 5, 13),
                    (33, 48, 48), (9, 64, 64), (9, 65, 48), (9, 48, 65),
                    (9, 200, 300), (4096, 48, 48)]:
        check_topk(torch, ops, ref, *topk_inputs(inp, B, L, K),
                   f"{(B, L, K)}")
    # pair list: bit equality with the pairwise kernel
    for B, N, d in [(129, 257, 33), (300, 1000, 64), (4096, 65536, 128)]:
        check_pairlist(torch, ops, rn(B, d), rn(N, d), 1 << 20, inp.gen)
    log("[kernels] int8 / top-k merge / pair-list: plain versions agree, "
        "int8 pairwise and gather bit-equal to their exact plain versions "
        "and the int8 bounds kernels (pairwise and gather, both gather "
        "entries) to the torch composition, the pair lists bit-equal to "
        "their kernels, int8 pairwise error below MATMUL_GUARD")


# ---------------------------------------------------------------------------
# phase 2b: the sketch (Hamming) and PDX kernels against their plain versions
# ---------------------------------------------------------------------------

def rand_words(inp, *shape):
    """Random int32 words covering the whole 32-bit pattern range."""
    t = inp.torch
    w = t.randint(0, 2**32, shape, device=inp.dev, generator=inp.gen,
                  dtype=t.int64)
    return t.where(w >= 2**31, w - 2**32, w).to(t.int32)


def check_hamming_pairwise(torch, ops, ref, cx, cy, chunk: int = 32) -> None:
    """The pairwise Hamming kernel equals its plain version exactly (the
    plain version in row chunks: it widens every word to int64)."""
    got = ops.pairwise_hamming(cx, cy)
    torch.cuda.synchronize()
    what = f"pairwise hamming {tuple(cx.shape)}x{tuple(cy.shape)}"
    if tuple(got.shape) != (cx.shape[0], cy.shape[0]):
        raise AssertionError(f"{what}: shape {tuple(got.shape)}")
    for r0 in range(0, cx.shape[0], chunk):
        want = ref.pairwise_hamming(cx[r0:r0 + chunk], cy)
        if not torch.equal(got[r0:r0 + chunk], want):
            bad = int((got[r0:r0 + chunk] != want).sum())
            raise AssertionError(f"{what}: {bad} counts differ")


def check_hamming_gather(torch, ops, ref, codes, cx, idx, what: str) -> None:
    got = ops.gather_hamming(codes, cx, idx)
    want = ref.gather_hamming(codes, cx, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"gather hamming {what}: "
                             f"{int((got != want).sum())} counts differ")


def pdx_inputs(torch, inp, n: int, b: int, d: int):
    """A PDX store over n random rows and b encoded queries."""
    from repro_torch.quant.pdx import build_pdx, pdx_queries
    st = build_pdx(inp.rn(max(n, 1), d))
    if n == 0:
        st = dataclasses.replace(
            st, vp=st.vp[:0], ftail=st.ftail[:0], q=st.q[:0],
            qslab=st.qslab[:0], qtail=st.qtail[:0], norms=st.norms[:0],
            err=st.err[:0])
    return st, pdx_queries(inp.rn(b, d), st)


def pdx_thetas(torch, st, qc) -> list[float]:
    """Two thresholds for the early-exit checks: one where most lanes
    retire after the first slab, one where most survive (from the median
    squared distance of a sample)."""
    x = qc.vp[:64]
    y = st.vp[:4096]
    if x.numel() == 0 or y.numel() == 0:
        return [1.0]
    med = float(torch.cdist(x, y).pow(2).median())
    return [(0.45 * med) ** 0.5, med ** 0.5]


def check_pdx_pairwise(torch, ops, ref, st, qc, theta: float,
                       chunk: int = 1 << 18) -> tuple[float, float]:
    """#10: bit for bit its plain version, d̂ (early exit off) and slab
    counts (on); on and off: survivors bit-identical, retired lanes +inf;
    every retired lane's plain full-scan certified lower bound exceeds θ².
    #10′: (lb, ub, nscan) with exit on and off bit for bit the composition
    ``ref.int8_bounds`` over #10's d̂, nscan #10's. Returns the max
    |kernel − plain| of #10 (exit off) and of #10′ (both bounds, exit off,
    against ``ref.pairwise_bounds_pdx``)."""
    from repro_torch.quant.cascade import MATMUL_GUARD
    args = (qc.q, st.q, st.scales, qc.qslab, st.qslab, qc.qtail, st.qtail,
            qc.norms, st.norms, qc.err, st.err, theta)
    kw = dict(slab=st.slab, dim=st.dim)
    d_off, n_off = ops.pairwise_sq_dists_pdx(*args, early_exit=False, **kw)
    d_on, n_on = ops.pairwise_sq_dists_pdx(*args, early_exit=True, **kw)
    b_off = ops.pairwise_bounds_pdx(*args, early_exit=False, **kw)
    b_on = ops.pairwise_bounds_pdx(*args, early_exit=True, **kw)
    torch.cuda.synchronize()
    B, N, S = qc.q.shape[0], st.q.shape[0], st.n_slabs
    what = f"pdx pairwise ({B},{st.dim})x({N},{st.dim}) S={S} θ={theta:.4f}"
    if d_off.shape != (B, N) or n_on.shape != (B, N) or any(
            t.shape != (B, N) for t in b_off + b_on):
        raise AssertionError(f"{what}: shapes {d_off.shape}/{n_on.shape}")
    if B * N == 0:
        return 0.0, 0.0
    if not (bool((n_off == S).all()) and torch.equal(b_off[2], n_off)
            and torch.equal(b_on[2], n_on)):
        raise AssertionError(f"{what}: exit off scanned fewer slabs, or the "
                             f"bounds entry's slab counts differ")
    surv = n_on == S
    if not torch.equal(d_on[surv], d_off[surv]):
        raise AssertionError(f"{what}: survivors differ with exit on/off")
    if not bool(torch.isinf(d_on[~surv]).all()):
        raise AssertionError(f"{what}: a retired lane is not +inf")
    th2 = float(np.float32(theta)) ** 2
    err = err_b = 0.0
    for c0 in range(0, N, chunk):
        c1 = min(c0 + chunk, N)
        sl = slice(c0, c1)
        pargs = (qc.q, st.q[sl], st.scales, qc.qslab, st.qslab[sl], qc.qtail,
                 st.qtail[sl], qc.norms, st.norms[sl], qc.err, st.err[sl],
                 theta)
        want, _ = ref.pairwise_sq_dists_pdx(*pargs, early_exit=False, **kw)
        _, wn = ref.pairwise_sq_dists_pdx(*pargs, early_exit=True, **kw)
        if not (torch.equal(d_off[:, sl], want)
                and torch.equal(n_on[:, sl], wn)):
            raise AssertionError(
                f"{what}: differs from the plain version (max err "
                f"{float((d_off[:, sl] - want).abs().max())}, "
                f"{int((n_on[:, sl] != wn).sum())} slab counts)")
        bnd = (qc.norms, st.norms[sl], qc.err, st.err[sl], MATMUL_GUARD)
        for (lb, ub, _), dk in ((b_off, d_off), (b_on, d_on)):
            wlb, wub = ref.int8_bounds(dk[:, sl], *bnd)
            if not (torch.equal(lb[:, sl], wlb)
                    and torch.equal(ub[:, sl], wub)):
                raise AssertionError(f"{what}: the bounds entry differs "
                                     f"from the composition over d̂")
        plb, pub, _ = ref.pairwise_bounds_pdx(*pargs, early_exit=False, **kw)
        for got, w in ((b_off[0][:, sl], plb), (b_off[1][:, sl], pub)):
            fin = torch.isfinite(w)
            if fin.any():
                err_b = max(err_b, float((got[fin] - w[fin]).abs().max()))
        err = max(err, float((d_off[:, sl] - want).abs().max()))
        lb, _ = ref.int8_bounds(want, *bnd)
        if not bool((lb[~surv[:, sl]] > th2).all()):
            raise AssertionError(f"{what}: a retired lane's certified lower "
                                 f"bound is within θ²")
        del want, wn, lb, plb, pub, wlb, wub
    log(f"[kernels] {what}: retired {float((~surv).float().mean()):.4f}; "
        f"d̂ and slab counts equal to the plain version's on all {B * N} "
        f"lanes; (lb, ub, nscan) the composition's, exit on and off")
    return err, err_b


def check_pdx_gather(torch, ops, ref, st, qc, idx, th2: float,
                     what: str) -> float:
    """#11: exit off against the plain version (|Δ| ≤ 1e-6·value +
    1e-6·max), NO_NODE (+inf, 0); exit on/off survivors bit-identical;
    retired lanes' plain full sums ≥ θ²."""
    args = (st.vp, st.ftail, st.ftail[:, 0].contiguous(), qc.vp, qc.ftail,
            qc.ftail[:, 0].contiguous(), idx, th2)
    d_off, n_off = ops.pdx_gather_sq_dists(*args, dim=st.dim,
                                           early_exit=False)
    d_on, n_on = ops.pdx_gather_sq_dists(*args, dim=st.dim, early_exit=True)
    want, wn = ref.pdx_gather_sq_dists(*args, dim=st.dim, early_exit=False)
    err = check_rows(torch, d_off, want, f"pdx gather {what}")
    valid = (idx >= 0) & (idx < st.vp.shape[0])
    S = st.n_slabs
    if not (torch.equal(n_off, torch.where(valid, S, 0).to(torch.int32))
            and torch.equal(n_on[~valid], n_off[~valid])):
        raise AssertionError(f"pdx gather {what}: slab counts wrong")
    surv = valid & (n_on == S)
    if not torch.equal(d_on[surv], d_off[surv]):
        raise AssertionError(f"pdx gather {what}: survivors differ on/off")
    ret = valid & (n_on < S)
    if not (bool(torch.isinf(d_on[ret]).all())
            and bool((want[ret] >= th2).all())):
        raise AssertionError(f"pdx gather {what}: a retired lane is within "
                             f"θ²")
    return err


def flip_bits(words: np.ndarray, m: int) -> np.ndarray:
    """A uint32 code row with its first ``m`` bits flipped: Hamming count
    ``m`` from the original."""
    out = words.copy()
    for i in range(m):
        out[i // 32] ^= np.uint32(1 << (i % 32))
    return out


def sketch_inputs(torch, inp, n: int, b: int, d: int, iso=None):
    """A sketch store over n random rows and b encoded queries ``(st,
    codes, cum)``; with ``iso`` the store's isometry factor replaced. With
    b > 0, store rows 0 … len(hs) − 1 lie exactly hs[k] bits from query 0
    (0 and d among them)."""
    from repro_torch.quant.sketch import build_sketch, sketch_queries
    st = build_sketch(inp.rn(n, d))
    qc, qcum = sketch_queries(inp.rn(b, d), st)
    hs = st.hs.cpu().numpy()
    codes = st.codes
    if b and n >= len(hs):
        q0 = qc[0].cpu().numpy().view(np.uint32)
        rows = np.stack([flip_bits(q0, int(m)) for m in hs])
        codes = codes.clone()
        codes[:len(hs)] = torch.from_numpy(rows.view(np.int32)).to(inp.dev)
    st = dataclasses.replace(st, codes=codes, iso=st.iso if iso is None else
                             torch.tensor(float(iso), device=inp.dev))
    return st, qc, qcum


def ulp_gap(torch, a, b) -> int:
    """The largest distance in f32 ulps between finite entries of a and b
    (on the ordered integer line of their bit patterns)."""
    fin = a.isfinite() & b.isfinite()
    if not bool(fin.any()):
        return 0

    def line(t):
        i = t[fin].contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((line(a) - line(b)).abs().max())


def check_sketch_bounds(torch, ops, ref, st, qc, qcum, idx,
                        what: str) -> float:
    """#9′ bit for bit the composition it replaced on the card (#9's
    Hamming counts, ``sketch_lower_bound_gather``, the estimate) and its
    plain version run there (the same with the plain Hamming counts),
    ``lb`` and ``est``; +inf for both outside the table. Returns the max
    |kernel − plain|: 0, bit for bit."""
    tabs = (qcum, st.cum, st.hs, st.iso)
    lb, est = ops.gather_sketch_bounds(st.codes, qc, idx, *tabs, dim=st.dim)
    for label, ham in (("plain version", ref.gather_hamming),
                       ("composition", ops.gather_hamming)):
        wlb, west = ref.gather_sketch_bounds(st.codes, qc, idx, *tabs,
                                             dim=st.dim, hamming=ham)
        torch.cuda.synchronize()
        if lb.shape != tuple(idx.shape) or est.shape != lb.shape:
            raise AssertionError(f"sketch bounds {what}: shapes "
                                 f"{tuple(lb.shape)}/{tuple(est.shape)}")
        for name, got, want in (("lb", lb, wlb), ("est", est, west)):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"sketch bounds {what}: {name} differs from the "
                    f"{label} on the card (+inf slots equal: "
                    f"{torch.equal(got.isinf(), want.isinf())}, largest gap "
                    f"{ulp_gap(torch, got, want)} ulps)")
    ok = (idx >= 0) & (idx < st.n_vectors)
    if not (torch.equal(lb.isfinite(), ok) and torch.equal(est.isfinite(),
                                                           ok)):
        raise AssertionError(f"sketch bounds {what}: +inf slots are not the "
                             f"ids outside the table")
    return 0.0


def check_pdx_compact(torch, ops, ref, st, qc, ids, mask, cap: int,
                      th2: float, what: str) -> float:
    """#11′ bit for bit the composition it replaced on the card
    (``band_compact`` → #11 → ``band_scatter`` and the scan counters):
    ``exact``, ``within``, ``n_masked``, ``n_scanned``, ``n_total``, early
    exit on and off; then with exit off against its plain version (the same
    over the plain PDX gather): ``exact`` as #11's tolerance, the rest
    equal. Returns the max |kernel − plain| of ``exact``."""
    args = (st.vp, st.ftail, st.ftail[:, 0].contiguous(), qc.vp, qc.ftail,
            qc.ftail[:, 0].contiguous(), ids, mask, cap, th2)
    kw = dict(dim=st.dim)
    names = ("exact", "within", "n_masked", "n_scanned", "n_total")
    for ee in (False, True):
        got = ops.pdx_compact_gather_sq_dists(*args, early_exit=ee, **kw)
        want = ref.pdx_compact_gather_sq_dists(
            *args, early_exit=ee, gather=ops.pdx_gather_sq_dists, **kw)
        torch.cuda.synchronize()
        bad = [n for n, g, w in zip(names, got, want)
               if g.dtype != w.dtype or not torch.equal(g, w)]
        if bad:
            raise AssertionError(f"pdx compact {what} exit {ee}: {bad} differ "
                                 f"from the composition on the card")
        if not ee:
            off = got
    plain = ref.pdx_compact_gather_sq_dists(*args, early_exit=False, **kw)
    err = check_rows(torch, off[0], plain[0], f"pdx compact {what}")
    bad = [n for n, g, w in zip(names[1:], off[1:], plain[1:])
           if not torch.equal(g, w)]
    if bad:
        raise AssertionError(f"pdx compact {what}: {bad} differ from the "
                             f"plain version")
    return err


def check_kernels_sketch_pdx(torch, ops, ref) -> None:
    """The Hamming (#8, #9) and PDX (#10, #11) kernels against their plain
    versions: ragged, sub-tile, empty and NO_NODE shapes at W = 2 and 4 /
    S = 1 and 2, and the shapes of the sketch8/pdx8 paths."""
    inp = Inputs(torch)
    for B, N, W in [(0, 5, 2), (4, 0, 4), (1, 1, 1), (3, 5, 2),
                    (65, 129, 4), (129, 257, 4), (200, 1000, 2),
                    (77, 300, 3), (64, 128, 40),
                    # the LSH estimator's sample at d = 128 and 64
                    (64, 2048, 4), (64, 2048, 2)]:
        check_hamming_pairwise(torch, ops, ref, rand_words(inp, B, W),
                               rand_words(inp, N, W))
    for B, K, W in [(0, 4, 4), (3, 0, 2), (1, 1, 1), (3, 5, 2), (7, 9, 4),
                    (33, 65, 3), (16, 40, 4)]:
        codes, cx = rand_words(inp, 50, W), rand_words(inp, B, W)
        for frac in (0.0, 0.5, 1.0):
            check_hamming_gather(torch, ops, ref, codes, cx,
                                 inp.ids(B, K, 50, frac), f"{(B, K, W)}")
    # the paths' shapes: the NLJ's query block against the 1M-row codes,
    # and the traversal's 256 x 128 ids over the merged codes
    check_hamming_pairwise(torch, ops, ref, rand_words(inp, 512, 4),
                           rand_words(inp, MAIN_N_DATA, 4))
    n_nodes = MAIN_N_DATA + MAIN_N_QUERY
    check_hamming_gather(torch, ops, ref, rand_words(inp, n_nodes, 4),
                         rand_words(inp, 256, 4), inp.ids(256, 128, n_nodes,
                                                          0.5), "main shape")
    log("[kernels] hamming pairwise / gather: equal to the plain versions")
    # #9′: checkpoint counts hit exactly, iso 0.75, W = 2, 4, 5, NO_NODE and
    # ids past the table, sub-block and empty shapes
    for (B, K, d) in [(1, 1, 40), (1, 20, 128), (7, 40, 150), (33, 300, 40),
                      (0, 4, 128), (3, 0, 128)]:
        st, qc, qcum = sketch_inputs(torch, inp, 300, B, d, iso=0.75)
        for frac in (0.0, 0.5):
            check_sketch_bounds(torch, ops, ref, st, qc, qcum,
                                inp.ids(B, K, 310, frac),
                                f"{(B, K, d)} frac {frac}")
    st, qc, qcum = sketch_inputs(torch, inp, n_nodes, 256, 128)
    check_sketch_bounds(torch, ops, ref, st, qc, qcum,
                        inp.ids(256, 128, n_nodes, 0.5), "main shape")
    del st, qc, qcum
    log("[kernels] sketch gather bounds (#9′): lb and est bit for bit the "
        "composition on the card")
    # PDX: S = 1 (d = 64, the OOD path) and S = 2 (d = 128), ragged and
    # empty, then the NLJ block (512 queries) against the paths' tables
    for (N, B, d) in [(5, 3, 64), (257, 129, 128), (1000, 200, 100),
                      (300, 77, 64), (0, 4, 128), (6, 0, 64)]:
        st, qc = pdx_inputs(torch, inp, N, B, d)
        for theta in pdx_thetas(torch, st, qc):
            check_pdx_pairwise(torch, ops, ref, st, qc, theta)
            th2 = float(np.float32(theta)) ** 2
            for frac in (0.0, 0.5, 1.0):
                check_pdx_gather(torch, ops, ref, st, qc,
                                 inp.ids(B, 65, max(N, 1), frac), th2,
                                 f"{(N, B, d)} frac {frac}")
    for N, d in [(MAIN_N_DATA, 128), (OOD_N_DATA, 64)]:
        st, qc = pdx_inputs(torch, inp, N, 512, d)
        for theta in pdx_thetas(torch, st, qc):
            check_pdx_pairwise(torch, ops, ref, st, qc, theta)
        del st, qc
    st, qc = pdx_inputs(torch, inp, n_nodes, 256, 128)
    for theta in pdx_thetas(torch, st, qc):
        th2 = float(np.float32(theta)) ** 2
        check_pdx_gather(torch, ops, ref, st, qc,
                         inp.ids(256, 128, n_nodes, 0.5), th2, "main shape")
    log("[kernels] pdx pairwise / gather: plain versions agree, exit on/off "
        "survivors bit-identical, every retired lane certified beyond θ²")
    # #11′: the band re-rank's (256, 1024) pool at cap 128 and 1024, a
    # band too wide for one round of its staged list, ragged pools, slabs
    # of 64 (S = 2), 30 (words) and 8; NO_NODE and ids past the table
    # inside the band; empty band rows
    for theta in pdx_thetas(torch, st, qc):
        th2 = float(np.float32(theta)) ** 2
        for cap, frac in ((128, 0.25), (1024, 0.25), (1024, 0.9)):
            ids = inp.ids(256, 1024, n_nodes + 5, 0.1)
            mask = inp.torch.rand((256, 1024), device=inp.dev,
                                  generator=inp.gen) < frac
            mask[::9] = False
            check_pdx_compact(torch, ops, ref, st, qc, ids, mask, cap, th2,
                              f"(256, 1024) cap {cap} band {frac}")
    del st, qc
    for (N, B, C, cap, d, slab) in [(500, 37, 300, 17, 70, 30),
                                    (500, 9, 700, 64, 40, 8),
                                    (500, 5, 2000, 1500, 128, 64),
                                    (5, 1, 1, 1, 64, 64)]:
        from repro_torch.quant.pdx import build_pdx, pdx_queries
        st = build_pdx(inp.rn(N, d), slab=slab)
        qc = pdx_queries(inp.rn(B, d), st)
        for theta in pdx_thetas(torch, st, qc):
            ids = inp.ids(B, C, N + 5, 0.1)
            mask = inp.torch.rand((B, C), device=inp.dev,
                                  generator=inp.gen) < 0.6
            mask[1::3] = False
            check_pdx_compact(torch, ops, ref, st, qc, ids, mask, cap,
                              float(np.float32(theta)) ** 2,
                              f"{(N, B, C, cap, d, slab)}")
    log("[kernels] pdx band re-rank (#11′): bit for bit the composition on "
        "the card, exit on and off")


# ---------------------------------------------------------------------------
# phase 2c: the fused NLJ count against its plain version
# ---------------------------------------------------------------------------

def check_nlj_count(torch, ops, ref, x, y, theta: float) -> float:
    """``nlj_count`` (a) equals, exactly, the pairwise kernel's distances
    compared with θ² and counted per row (the two kernels share the tile
    and the epilogue, and the wrappers the norms), and (b) equals its
    plain version exactly but for pairs whose plain distance lies within
    the pairwise tolerance of θ², 1e-5·(xn+yn) + 1e-5·d (the plain
    version's matrix product is cuBLAS's, summed in another order): each
    query's |kernel − plain| is at most its count of such pairs. Returns
    the largest |kernel − plain| over the queries."""
    B, N, d = x.shape[0], y.shape[0], x.shape[1]
    what = f"nlj_count ({B},{d})x({N},{d}) θ={theta:.4f}"
    got = ops.nlj_count(x, y, theta=theta)
    torch.cuda.synchronize()
    if got.shape != (B,) or got.dtype != torch.int32:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)}")
    if B * N * d == 0:                   # the reference's shape contract
        n = N if (d == 0 and theta > 0) else 0
        if not bool((got == n).all()):
            raise AssertionError(f"{what}: empty-shape counts wrong")
        return 0.0
    th2 = ref.sq_theta(theta)
    via = (ops.pairwise_sq_dists(x, y) < th2).sum(1, dtype=torch.int32)
    if not torch.equal(got, via):
        raise AssertionError(f"{what}: {int((got != via).sum())} counts "
                             f"differ from the pairwise kernel's")
    del via
    plain = ref.nlj_count(x, y, theta)
    diff = (got - plain).abs()
    rows = diff.nonzero().squeeze(1)
    yn = ref.sq_norms(y)
    for r in rows.tolist():
        dp = ref.pairwise_sq_dists(x[r:r + 1], y)[0]
        tol = 1e-5 * (ref.sq_norms(x[r:r + 1]) + yn) + 1e-5 * dp
        band = int(((dp - th2).abs() <= tol).sum())
        if int(diff[r]) > band:
            raise AssertionError(f"{what}: row {r} differs from the plain "
                                 f"version by {int(diff[r])}, beyond its "
                                 f"{band} pairs within tolerance of θ²")
    if rows.numel():
        log(f"[kernels] {what}: equal to the pairwise kernel's counts; "
            f"{rows.numel()} of {B} rows differ from the plain version, "
            f"each by at most its pairs within tolerance of θ²")
    return float(diff.max())


def nlj_theta(torch, ref, x, y, frac: float) -> float:
    """θ at which about ``frac`` of the pairs of a sample lie within it."""
    d = ref.pairwise_sq_dists(x[:64], y[:65536]).flatten()
    k = max(1, min(d.numel(), int(frac * d.numel())))
    return float(torch.kthvalue(d.cpu(), k).values) ** 0.5


def check_kernels_nlj(torch, ops, ref) -> float:
    """#5: ragged, sub-tile, empty shapes, d % 4 != 0, θ = 0 and the NLJ
    block (512,128)x(1M,128) with about 1% of its pairs within θ."""
    inp = Inputs(torch)
    for B, N, d in [(0, 5, 8), (4, 0, 8), (5, 7, 0), (1, 1, 1), (3, 5, 7),
                    (129, 257, 3), (200, 1000, 130), (1000, 3000, 33),
                    (300, 700, 128)]:
        x, y = inp.rn(B, d), inp.rn(N, d)
        theta = nlj_theta(torch, ref, x, y, 0.3) if B * N * d else 1.0
        for th in (theta, 0.0):
            check_nlj_count(torch, ops, ref, x, y, th)
    x, y = inp.rn(512, 128), inp.rn(MAIN_N_DATA, 128)
    theta = nlj_theta(torch, ref, x, y, 0.01)
    err = check_nlj_count(torch, ops, ref, x, y, theta)
    log(f"[kernels] nlj_count: equal to the pairwise kernel's counts at "
        f"every shape; NLJ block max |kernel − plain| = {err}")
    return err


def distinct_rows(torch, idxs) -> float:
    """The distinct valid ids an id set reads, averaged over the sets: the
    table rows a gather must move at least once (its bound's bytes)."""
    return sum(torch.unique(i[i >= 0]).numel() for i in idxs) / len(idxs)


def nlj_pair_block(torch, inp, n_rows: int):
    """The NLJ's escalation shape: PAIR_BLOCK (query, data) pairs over an
    NLJ_QBLOCK-query block, query-major with the data ids of each query
    ascending (as ``nonzero`` gives them), ids drawn from ``n_rows``."""
    per = PAIR_BLOCK // NLJ_QBLOCK
    qi = torch.arange(NLJ_QBLOCK, device=inp.dev, dtype=torch.int32)
    yi = torch.randint(0, n_rows, (NLJ_QBLOCK, per), device=inp.dev,
                       generator=inp.gen, dtype=torch.int32)
    return (qi.repeat_interleave(per),
            torch.sort(yi, dim=1)[0].reshape(-1).contiguous())


def time_kernels(torch, ops, ref, band_frac: float) -> dict:
    """Each kernel at the main path's shapes: agreement with its plain
    version, device time beside its bound, the plain version's time and a
    library call's (and for the fused entries the eager composition's they
    replaced). ``band_frac`` is the pdx8 join's band occupancy, the share
    of its pool slots that were re-ranked. Every entry's CUDA-event median is taken first, in one
    pass before any profiler session (it is the per-call cost the joins
    see); the device times under torch.profiler come after. Runs after the
    join phases: an attached profiler slows every later launch."""
    inp = Inputs(torch)
    rn, ids = inp.rn, inp.ids
    out = {}
    # (record, key, fn): device times taken at the end; each timed fn binds
    # its inputs as default arguments, for the names move on to the next
    # kernel's before it runs again
    pending = []

    def entry(shape, err, fn, plain, library, nbytes, flops,
              peak=PEAK_F32_FLOPS):
        bms, by = bound_ms(nbytes, flops, peak)
        r = dict(shape=shape, max_abs_err=err, event_ms=event_ms(torch, fn),
                 bound_ms=bms, bound_by=by, library_ms=None)
        pending.extend([(r, "ms", fn), (r, "plain_ms", plain)]
                       + ([] if library is None
                          else [(r, "library_ms", library)]))
        return r

    # pairwise at the kNN build's block shape (qblock 4096 x dblock 65536);
    # compute-bound, so the L2-resident inputs do not flatter it
    B, N, d = 4096, 65536, 128
    x, y = rn(B, d), rn(N, d)
    out["pairwise_sq_dists"] = entry(
        f"({B},{d})x({N},{d})", check_pairwise(torch, ops, ref, x, y),
        lambda _, x=x, y=y: ops.pairwise_sq_dists(x, y),
        lambda _, x=x, y=y: ref.pairwise_sq_dists(x, y),
        lambda _, x=x, y=y: torch.cdist(x, y),
        (B * d + N * d + B * N) * 4, 2.0 * B * N * d)
    # the CUDA cores' f32 ceiling as cuBLAS reaches it: the bare product,
    # TF32 off (logged beside the kernel, used nowhere in the port)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 timings would not be f32")
    mm = dict(flops=2.0 * B * N * d)
    pending.append((mm, "ms", lambda _, x=x, y=y: torch.mm(x, y.T)))
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
        lambda _, x=x, c=c: ops.rowwise_sq_dists(x, c),
        lambda _, x=x, c=c: ref.rowwise_sq_dists(x, c),
        lambda _, x=x, c=c: torch.cdist(x[:, None], c),
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
    rows = distinct_rows(torch, idxs)
    out["gather_sq_dists"] = entry(
        f"({n_nodes},{d}) rows, ({B},{K}) ids, {n_valid:.0f} valid",
        max(check_rows(torch, ops.gather_sq_dists(v, x, i),
                       ref.gather_sq_dists(v, x, i), "gather main shape")
            for i in idxs[:3]),
        lambda r, v=v, x=x, i=idxs: ops.gather_sq_dists(v, x, i[r]),
        lambda r, v=v, x=x, i=idxs: ref.gather_sq_dists(v, x, i[r]), None,
        (rows * d + B * d + 2 * B * K) * 4, 3.0 * n_valid * d)
    # the same call through the custom op repro_torch::gather_sq_dists (the
    # route a dispatch mode sees; real tensors outside one launch directly)
    out["gather_sq_dists"]["op_event_ms"] = event_ms(
        torch, lambda r, v=v, x=x, i=idxs:
        torch.ops.repro_torch.gather_sq_dists(v, x, i[r]))
    # its bf16 entry on the same ids over a bf16 table: half the row bytes
    vb, xb = v.bfloat16(), x.bfloat16()
    out["gather_sq_dists_bf16"] = entry(
        f"({n_nodes},{d}) bf16 rows, ({B},{K}) ids, {n_valid:.0f} valid",
        max(check_bf16_gather(torch, ops, ref, vb, xb, i, "main shape")
            for i in idxs[:3]),
        lambda r, v=vb, x=xb, i=idxs: ops.gather_sq_dists(v, x, i[r]),
        lambda r, v=vb, x=xb, i=idxs: ref.gather_sq_dists(v, x, i[r]), None,
        rows * d * 2 + B * d * 2 + 2 * B * K * 4, 3.0 * n_valid * d)
    del vb, xb

    # its pair-list entry at the NLJ's pair block: P = 4,194,304 pairs
    # over a 512-query block and the 1M data rows, query-major with the
    # data ids ascending in each query, as nonzero gives them; checked bit
    # for bit against the (B, K) entry over a copy of the query rows
    x512 = rn(NLJ_QBLOCK, d)
    qi, yi = nlj_pair_block(torch, inp, MAIN_N_DATA)
    P = qi.numel()
    pairs = ops.gather_sq_dists_pairs(v, x512, qi, yi)
    if not torch.equal(pairs, ops.gather_sq_dists(
            v, x512[qi.long()], yi[:, None].contiguous())[:, 0]):
        raise AssertionError("gather pair block: the pair-list entry "
                             "differs from the (B, K) entry")
    out["gather_sq_dists_pairs"] = entry(
        f"{P} pairs, ({NLJ_QBLOCK},{d}) x ({n_nodes},{d}), ids < "
        f"{MAIN_N_DATA}",
        check_rows(torch, pairs, ref.gather_sq_dists_pairs(v, x512, qi, yi),
                   "gather pair block"),
        lambda _, a=(v, x512, qi, yi): ops.gather_sq_dists_pairs(*a),
        lambda _, a=(v, x512, qi, yi): ref.gather_sq_dists_pairs(*a), None,
        (distinct_rows(torch, [yi]) * d + NLJ_QBLOCK * d + 3 * P) * 4,
        3.0 * P * d)
    del v, x, idxs, x512, pairs

    # pair list at the sq8 build's re-rank: survivors of a 4096-row block
    # (~256 per row) over the 1.01M-row table, in row order
    from repro_torch.quant.store import build_store, quantize_queries
    B, S, d = 4096, 256, 128
    v, x = rn(n_nodes, d), rn(B, d)
    vn, xn = ref.sq_norms(v), ref.sq_norms(x)
    qi = torch.arange(B, device=inp.dev, dtype=torch.int32
                      ).repeat_interleave(S)
    yi = torch.randint(0, n_nodes, (B * S,), device=inp.dev,
                       generator=inp.gen, dtype=torch.int32)
    P = B * S
    out["pairlist_sq_dists"] = entry(
        f"{P} pairs, ({B},{d}) x ({n_nodes},{d})",
        check_rows(torch, ops.pairlist_sq_dists(x, v, qi, yi, xn=xn, yn=vn),
                   ref.pairlist_sq_dists(x, v, xn, vn, qi, yi),
                   "pairlist main shape"),
        lambda _, a=(x, v, qi, yi), kw=dict(xn=xn, yn=vn):
            ops.pairlist_sq_dists(*a, **kw),
        lambda _, a=(x, v, xn, vn, qi, yi): ref.pairlist_sq_dists(*a), None,
        P * d * 4 + B * d * 4 + P * 8 + (B + P) * 4 + P * 4, 2.0 * P * d)
    del v, x, qi, yi

    # top-k merge at the kNN block: (4096,48) beam + (4096,48) candidates
    B, L, K = 4096, 48, 48
    bd, bi, cd, ci = topk_inputs(inp, B, L, K)
    check_topk(torch, ops, ref, bd, bi, cd, ci, "main shape")
    out["topk_merge"] = entry(
        f"({B},{L})+({B},{K})", 0.0,
        lambda _, a=(bd, bi, cd, ci): ops.topk_merge(*a),
        lambda _, a=(bd, bi, cd, ci): ref.topk_merge(*a), None,
        B * (L + K) * 8 + B * L * 8, float(B * (L + K) * (L + K)))
    del bd, bi, cd, ci

    # int8 pairwise at the sq8 kNN block; the library call is
    # torch._int_mm per group plus the same epilogue
    B, N, d = 4096, 65536, 128
    st = build_store(rn(N, d))
    qx, xn, xe = quantize_queries(rn(B, d), st)
    s2 = float(st.scales[0]) ** 2
    yt = st.q.t()

    def int_mm(_, qx=qx, yt=yt, xn=xn, st=st, s2=s2):
        acc = torch._int_mm(qx, yt)
        return (xn[:, None] + st.norms[None, :]
                - 2.0 * (s2 * acc.float())).clamp_min(0.0)
    try:
        int_mm(0)
        lib = int_mm
    except RuntimeError as e:            # the library refuses the layout
        log(f"[kernels] torch._int_mm not timed: {e}")
        lib = None
    e8 = entry(
        f"({B},{d})x({N},{d}) int8",
        check_int8_pairwise(torch, ops, ref, st, qx, xn),
        lambda _, qx=qx, st=st, xn=xn: ops.pairwise_sq_dists_int8(
            qx, st.q, st.scales, xn=xn, yn=st.norms),
        lambda _, qx=qx, st=st: ref.pairwise_sq_dists_int8(qx, st.q,
                                                           st.scales), lib,
        B * d + N * d + (B + N) * 4 + 4 + B * N * 4, 2.0 * B * N * d,
        PEAK_INT8_OPS)    # int8 operations on the int8 tensor-core peak
    out["pairwise_sq_dists_int8"] = e8
    # #6 at the streaming parent choice's shape: a wave of 256 codes
    # against the carry window padded to 4096 donors (checked bit for bit
    # there too); logged beside its row
    Bp, Np = 256, 4096
    stp = build_store(rn(Np, d))
    qxp, xnp, _ = quantize_queries(rn(Bp, d), stp)
    e8["parent_shape"] = f"({Bp},{d})x({Np},{d}) int8"
    e8["parent_max_abs_err"] = check_int8_pairwise(torch, ops, ref, stp,
                                                   qxp, xnp)
    parent_fn = (lambda _, qx=qxp, st=stp, xn=xnp: ops.pairwise_sq_dists_int8(
        qx, st.q, st.scales, xn=xn, yn=st.norms))
    e8["parent_event_ms"] = event_ms(torch, parent_fn)
    e8["parent_bound_ms"], e8["parent_bound_by"] = bound_ms(
        Bp * d + Np * d + (Bp + Np) * 4 + 4 + Bp * Np * 4, 2.0 * Bp * Np * d,
        PEAK_INT8_OPS)
    pending.append((e8, "parent_ms", parent_fn))
    del stp, qxp, xnp

    # the fused bounds entry (#6') at the same block: d̂ and both bounds in
    # one pass, two f32 outputs. Plain: the composition over the plain
    # (dequantizing) d̂; library: torch._int_mm, the epilogue and the same
    # composition
    from repro_torch.quant.cascade import MATMUL_GUARD
    ye = st.err
    kw = dict(xn=xn, yn=st.norms, xe=xe, ye=ye, guard=MATMUL_GUARD)
    nb = B * d + N * d + 2 * (B + N) * 4 + 4 + 2 * B * N * 4
    e8b = entry(
        f"({B},{d})x({N},{d}) int8 -> (lb, ub)",
        check_int8_bounds(torch, ops, ref, st, qx, xn, xe),
        lambda _, qx=qx, st=st, kw=kw: ops.pairwise_bounds_int8(
            qx, st.q, st.scales, **kw),
        lambda _, qx=qx, st=st, a=(xn, st.norms, xe, ye, MATMUL_GUARD):
            ref.int8_bounds(ref.pairwise_sq_dists_int8(qx, st.q, st.scales),
                            *a),
        None if lib is None else (
            lambda _, lib=lib, a=(xn, st.norms, xe, ye, MATMUL_GUARD):
                ref.int8_bounds(lib(0), *a)),
        nb, 2.0 * B * N * d, PEAK_INT8_OPS)
    out["pairwise_bounds_int8"] = e8b
    del st, qx, xn, yt, xe, ye

    # int8 gather (the rowwise kernel's gather entry) at the traversal's
    # expand shape over the merged table, half NO_NODE, cold ids
    B, K, d = 256, 128, 128
    st = build_store(rn(n_nodes, d))
    qx = quantize_queries(rn(B, d), st)[0]
    idxs = [ids(B, K, n_nodes, 0.5) for _ in range(REPS)]
    n_valid = sum(int((i >= 0).sum()) for i in idxs) / REPS
    rows = distinct_rows(torch, idxs)
    out["rowwise_sq_dists_int8"] = entry(
        f"gather form: ({n_nodes},{d}) int8 rows, ({B},{K}) ids, "
        f"{n_valid:.0f} valid",
        max(check_int8_rows(torch, ops.gather_sq_dists_int8(
            st.q, qx, i, st.scales), ref.gather_sq_dists_int8(
            st.q, qx, i, st.scales), "int8 gather main shape")
            for i in idxs[:3]),
        lambda r, st=st, qx=qx, i=idxs: ops.gather_sq_dists_int8(
            st.q, qx, i[r], st.scales),
        lambda r, st=st, qx=qx, i=idxs: ref.gather_sq_dists_int8(
            st.q, qx, i[r], st.scales),
        None, rows * d + B * d + 2 * B * K * 4 + 4, 3.0 * n_valid * d)

    # #7': the same gather with the int8 tier's certified bounds in its
    # epilogue (Int8Tier.gather_bounds); plain: the torch composition over
    # the plain (dequantizing) d̂. Bit for bit the composition over the
    # kernel's d̂
    qe = quantize_queries(rn(B, d), st)
    qx, xe = qe[0], qe[2]
    err7 = 0.0
    for i in idxs[:3]:
        check_int8_gathers(torch, ops, ref, st.q, qx, i, st.scales,
                           st.group_size, st.err, xe, "main shape")
        err7 = max(err7, check_int8_bound_rows(
            torch, ops.gather_bounds_int8(st.q, qx, i, st.scales, err=st.err,
                                          qerr=xe),
            ref.gather_bounds_int8(st.q, qx, i, st.scales, st.err, xe),
            "int8 gather bounds main shape"))
    out["gather_bounds_int8"] = entry(
        f"({n_nodes},{d}) int8 rows, ({B},{K}) ids, {n_valid:.0f} valid "
        f"-> (lb, ub)", err7,
        lambda r, st=st, qx=qx, xe=xe, i=idxs: ops.gather_bounds_int8(
            st.q, qx, i[r], st.scales, err=st.err, qerr=xe),
        lambda r, st=st, qx=qx, xe=xe, i=idxs: ref.gather_bounds_int8(
            st.q, qx, i[r], st.scales, st.err, xe), None,
        rows * (d + 4) + B * (d + 4) + 3 * B * K * 4 + 4, 3.0 * n_valid * d)

    # #7' pair-list entry at the NLJ's pair block (the sketch8 escalation's
    # Int8Tier.pair_refine), over the 1M data rows' codes: bit for bit the
    # composition over the (B, K) entry's d̂ on a (P, 1) id column over a
    # copy of the query rows (itself bit for bit its exact plain version),
    # in slices; then against its plain version
    q512, _, e512 = quantize_queries(rn(NLJ_QBLOCK, d), st)
    qi, yi = nlj_pair_block(torch, inp, MAIN_N_DATA)
    P = qi.numel()
    lb, ub = ops.gather_bounds_int8_pairs(st.q, q512, qi, yi, st.scales,
                                          err=st.err, qerr=e512)
    for c0 in range(0, P, 1 << 20):
        sl = slice(c0, c0 + (1 << 20))
        q_c = q512[qi[sl].long()]
        y_c = yi[sl][:, None].contiguous()
        dh = ops.gather_sq_dists_int8(st.q, q_c, y_c, st.scales)[:, 0]
        if not torch.equal(dh, ref.gather_sq_dists_int8_exact(
                st.q, q_c, y_c, st.scales)[:, 0]):
            raise AssertionError("int8 gather pair block: differs from its "
                                 "exact plain version")
        wlb, wub = ref.gather_bounds(dh, e512[qi[sl].long()]
                                     + st.err[yi[sl].long()])
        if not (torch.equal(lb[sl], wlb) and torch.equal(ub[sl], wub)):
            raise AssertionError("int8 gather bounds pair block: differ from "
                                 "the composition over the kernel's d̂")
    err7 = check_int8_bound_rows(
        torch, (lb, ub), ref.gather_bounds_int8_pairs(
            st.q, q512, qi, yi, st.scales, st.err, e512),
        "int8 gather bounds pair block")
    rows = distinct_rows(torch, [yi])
    a7 = (st.q, q512, qi, yi, st.scales)
    out["gather_bounds_int8_pairs"] = entry(
        f"{P} pairs, ({NLJ_QBLOCK},{d}) x ({n_nodes},{d}) int8, ids < "
        f"{MAIN_N_DATA} -> (lb, ub)", err7,
        lambda _, a=a7, kw=dict(err=st.err, qerr=e512):
            ops.gather_bounds_int8_pairs(*a, **kw),
        lambda _, a=a7 + (st.err, e512): ref.gather_bounds_int8_pairs(*a),
        None,
        rows * (d + 4) + NLJ_QBLOCK * (d + 4) + 4 * P * 4 + 4, 3.0 * P * d)
    del st, qx, idxs, q512, dh, lb, ub, wlb, wub, a7

    # pairwise Hamming at the sketch NLJ's block: 512 queries x the 1M-row
    # codes, W = 4 (d = 128); XOR, popcount and add per word counted as
    # operations on the CUDA cores (the f32 rate)
    B, N, W = 512, MAIN_N_DATA, 4
    cx, cy = rand_words(inp, B, W), rand_words(inp, N, W)
    check_hamming_pairwise(torch, ops, ref, cx, cy)
    out["pairwise_hamming"] = entry(
        f"({B},{W})x({N},{W}) int32 words", 0.0,
        lambda _, cx=cx, cy=cy: ops.pairwise_hamming(cx, cy),
        lambda _, cx=cx, cy=cy: [ref.pairwise_hamming(cx[r:r + 32], cy)
                                 for r in range(0, len(cx), 32)],  # int64
        None,
        (B + N) * W * 4 + B * N * 4, 3.0 * B * N * W)
    del cx, cy

    # gather Hamming at the traversal's expand shape over the merged codes
    B, K, W = 256, 128, 4
    codes, cx = rand_words(inp, n_nodes, W), rand_words(inp, B, W)
    idxs = [ids(B, K, n_nodes, 0.5) for _ in range(REPS)]
    n_valid = sum(int((i >= 0).sum()) for i in idxs) / REPS
    for i in idxs[:3]:
        check_hamming_gather(torch, ops, ref, codes, cx, i, "main shape")
    out["rowwise_hamming"] = entry(
        f"gather form: ({n_nodes},{W}) words, ({B},{K}) ids, "
        f"{n_valid:.0f} valid", 0.0,
        lambda r, c=codes, cx=cx, i=idxs: ops.gather_hamming(c, cx, i[r]),
        lambda r, c=codes, cx=cx, i=idxs: ref.gather_hamming(c, cx, i[r]),
        None,
        n_valid * W * 4 + B * W * 4 + 2 * B * K * 4, 3.0 * n_valid * W)
    del codes, cx, idxs

    # #9′ at the same shape over a sketch store of the merged table's size
    # (d = 128: W = 4, 17 checkpoints); plain: the composition over the
    # plain Hamming counts; composition: the one it replaced (#9, then the
    # bound and the estimate in eager torch). Bytes: each valid id's code
    # row and two slack entries, the queries' rows, the ids and two outputs
    st, qc, qcum = sketch_inputs(torch, inp, n_nodes, B, 128)
    W, Kc = st.n_words, st.n_checkpoints
    idxs = [ids(B, K, n_nodes, 0.5) for _ in range(REPS)]
    n_valid = sum(int((i >= 0).sum()) for i in idxs) / REPS
    for i in idxs[:3]:
        check_sketch_bounds(torch, ops, ref, st, qc, qcum, i, "main shape")
    a9 = (st.codes, qc)
    t9 = (qcum, st.cum, st.hs, st.iso)
    e9 = entry(
        f"({n_nodes},{W}) words + ({n_nodes},{Kc}) slack, ({B},{K}) ids, "
        f"{n_valid:.0f} valid -> (lb, est)", 0.0,
        lambda r, a=a9, t=t9, i=idxs: ops.gather_sketch_bounds(
            *a, i[r], *t, dim=128),
        lambda r, a=a9, t=t9, i=idxs: ref.gather_sketch_bounds(
            *a, i[r], *t, dim=128), None,
        n_valid * (W + 2) * 4 + B * (W + Kc) * 4 + Kc * 4 + 3 * B * K * 4,
        (3 * W + 40) * n_valid)
    comp = (lambda r, a=a9, t=t9, i=idxs: ref.gather_sketch_bounds(
        *a, i[r], *t, dim=128, hamming=ops.gather_hamming))
    e9["composition_event_ms"] = event_ms(torch, comp)
    pending.append((e9, "composition_ms", comp))
    out["gather_sketch_bounds"] = e9
    del st, qc, qcum, idxs, a9, t9

    # PDX pairwise at the pdx8 NLJ's block: 512 queries x 1M rows, d = 128
    # (two slabs), early exit on at a θ where about half the lanes retire
    # after the first slab, and off (the NLJ runs both); the MACs counted
    # are what this run's lanes scanned, the bytes each input once and the
    # outputs. The library call: torch._int_mm per slab + epilogue (no exit)
    from repro_torch.quant.cascade import MATMUL_GUARD
    B, N, d = 512, MAIN_N_DATA, 128
    st, qc = pdx_inputs(torch, inp, N, B, d)
    theta = pdx_thetas(torch, st, qc)[0]
    args = (qc.q, st.q, st.scales, qc.qslab, st.qslab, qc.qtail, st.qtail,
            qc.norms, st.norms, qc.err, st.err, theta)
    kw = dict(slab=st.slab, dim=st.dim, early_exit=True)
    kw_off = dict(kw, early_exit=False)
    err, err_b = check_pdx_pairwise(torch, ops, ref, st, qc, theta)
    _, nscan = ops.pairwise_sq_dists_pdx(*args, **kw)
    scanned = float(nscan.double().sum())      # slabs scanned over lanes
    del nscan
    S, slab = st.n_slabs, st.slab
    xs = [qc.q[:, k * slab:(k + 1) * slab].contiguous() for k in range(S)]
    ys = [st.q[:, k * slab:(k + 1) * slab].contiguous().t() for k in range(S)]

    def int_mm_pdx(_, B=B, N=N, S=S, st=st, qc=qc, xs=xs, ys=ys):
        acc = torch.zeros((B, N), device=inp.dev)
        for k in range(S):
            s2 = st.scales[k] * st.scales[k]
            dot = torch._int_mm(xs[k], ys[k]).float()
            acc += (qc.qslab[:, k, None] + st.qslab[None, :, k]
                    - 2.0 * s2 * dot).clamp_min(0.0)
        return acc
    try:
        int_mm_pdx(0)
        lib = int_mm_pdx
    except RuntimeError as e:            # the library refuses the layout
        log(f"[kernels] torch._int_mm (PDX) not timed: {e}")
        lib = None
    n_in = (B + N) * (d + 4 * (2 * S + 2))
    frac = scanned / (B * N * S)
    for name, fn, plain, library, n_out, e_ in (
            ("pairwise_sq_dists_pdx", ops.pairwise_sq_dists_pdx,
             ref.pairwise_sq_dists_pdx, lib, 2, err),
            # #10′: (lb, ub, nscan); library: the same + ref.int8_bounds
            ("pairwise_bounds_pdx", ops.pairwise_bounds_pdx,
             ref.pairwise_bounds_pdx,
             None if lib is None else (
                 lambda _, lib=lib, a=(qc.norms, st.norms, qc.err, st.err,
                                       MATMUL_GUARD):
                     ref.int8_bounds(lib(0), *a)), 3, err_b)):
        e = entry(f"({B},{d})x({N},{d}) int8, S={S}, early exit on, "
                  f"{frac:.4f} of slabs scanned"
                  + (" -> (lb, ub, nscan)" if n_out == 3 else ""), e_,
                  lambda _, f=fn, a=args, kw=kw: f(*a, **kw),
                  lambda _, f=plain, a=args, kw=kw: f(*a, **kw), library,
                  n_in + n_out * B * N * 4, 2.0 * scanned * slab,
                  PEAK_INT8_OPS)
        # early exit off: every slab scanned, the same bytes
        off = (lambda _, f=fn, a=args, kw=kw_off: f(*a, **kw))
        e["event_ms_exit_off"] = event_ms(torch, off)
        pending.append((e, "ms_exit_off", off))
        out[name] = e
    del st, qc, args, xs, ys

    # PDX gather at the band re-rank's shape: 256 x 128 ids over the
    # merged table's f32 PDX rows, half NO_NODE, early exit on; bytes are
    # the slabs this run's valid lanes scanned
    B, K, d = 256, 128, 128
    st, qc = pdx_inputs(torch, inp, n_nodes, B, d)
    th2 = float(np.float32(pdx_thetas(torch, st, qc)[0])) ** 2
    vn, xn = st.ftail[:, 0].contiguous(), qc.ftail[:, 0].contiguous()
    idxs = [ids(B, K, n_nodes, 0.5) for _ in range(REPS)]
    err = max(check_pdx_gather(torch, ops, ref, st, qc, i, th2, "main shape")
              for i in idxs[:3])
    scanned = sum(float(ops.pdx_gather_sq_dists(
        st.vp, st.ftail, vn, qc.vp, qc.ftail, xn, i, th2, dim=d,
        early_exit=True)[1].double().sum()) for i in idxs) / REPS
    n_valid = sum(int((i >= 0).sum()) for i in idxs) / REPS
    S, slab = st.n_slabs, st.slab
    out["pdx_gather_sq_dists"] = entry(
        f"({n_nodes},{d}) f32 PDX rows, ({B},{K}) ids, {n_valid:.0f} valid, "
        f"{scanned / max(n_valid * S, 1):.4f} of their slabs scanned", err,
        lambda r, a=(st.vp, st.ftail, vn, qc.vp, qc.ftail, xn), i=idxs,
        t2=th2, kw=dict(dim=d, early_exit=True):
            ops.pdx_gather_sq_dists(*a, i[r], t2, **kw),
        lambda r, a=(st.vp, st.ftail, vn, qc.vp, qc.ftail, xn), i=idxs,
        t2=th2, kw=dict(dim=d, early_exit=True):
            ref.pdx_gather_sq_dists(*a, i[r], t2, **kw), None,
        scanned * slab * 4 + n_valid * (S + 1) * 4 + B * (d + S + 1) * 4
        + 3 * B * K * 4, 3.0 * scanned * slab)

    # #11′ at the band re-rank's pool: (256, 1024) ids over the same rows,
    # a band of band_frac of the slots (the pdx8 join's occupancy), cap
    # 1024, early exit on at the same θ; plain: the same over the plain
    # PDX gather; composition: band_compact → #11 → band_scatter. Bytes:
    # the pool's ids and mask, the outputs, the query rows, and the slabs
    # (with their tails) this run's compacted lanes scanned
    C = 1024
    pool = ids(B, C, n_nodes, 0.0)
    masks = [torch.rand((B, C), device=inp.dev, generator=inp.gen)
             < band_frac for _ in range(REPS)]
    a11 = (st.vp, st.ftail, vn, qc.vp, qc.ftail, xn, pool)
    kw11 = dict(dim=d, early_exit=True)
    err = max(check_pdx_compact(torch, ops, ref, st, qc, pool, m, C, th2,
                                "main shape") for m in masks[:3])
    runs = [ops.pdx_compact_gather_sq_dists(*a11, m, C, th2, **kw11)
            for m in masks]
    dims = sum(int(r[3]) for r in runs) / REPS
    lanes = sum(int(r[4]) for r in runs) / REPS / d
    del runs
    e11 = entry(
        f"({B},{C}) pool over ({n_nodes},{d}) f32 PDX rows, band "
        f"{band_frac:.4f} of the slots ({lanes:.0f} lanes), cap {C}, "
        f"{dims / max(lanes * d, 1):.4f} of their dims scanned", err,
        lambda r, a=a11, m=masks, t2=th2, kw=kw11:
            ops.pdx_compact_gather_sq_dists(*a, m[r], C, t2, **kw),
        lambda r, a=a11, m=masks, t2=th2, kw=kw11:
            ref.pdx_compact_gather_sq_dists(*a, m[r], C, t2, **kw), None,
        B * C * 10 + B * 4 + B * (d + S + 1) * 4 + dims * 4
        + lanes * (S + 1) * 4 + 16, 3.0 * dims)
    comp = (lambda r, a=a11, m=masks, t2=th2, kw=kw11:
            ref.pdx_compact_gather_sq_dists(
                *a, m[r], C, t2, gather=ops.pdx_gather_sq_dists, **kw))
    e11["composition_event_ms"] = event_ms(torch, comp)
    pending.append((e11, "composition_ms", comp))
    out["pdx_compact_gather"] = e11
    del st, qc, idxs, pool, masks, a11

    # the fused NLJ count at the NLJ block: 512 queries x the 1M rows,
    # about 1% of the pairs within θ; the library call is torch.matmul
    # (TF32 off) with the epilogue, the compare and the row sum
    B, N, d = 512, MAIN_N_DATA, 128
    x, y = rn(B, d), rn(N, d)
    theta = nlj_theta(torch, ref, x, y, 0.01)
    th2 = ref.sq_theta(theta)
    xn, yn = ref.sq_norms(x), ref.sq_norms(y)
    within = float(ops.nlj_count(x, y, theta=theta).sum()) / (B * N)
    out["nlj_count"] = entry(
        f"({B},{d})x({N},{d}), {within:.4f} of pairs within θ",
        check_nlj_count(torch, ops, ref, x, y, theta),
        lambda _, x=x, y=y, t=theta: ops.nlj_count(x, y, theta=t),
        lambda _, x=x, y=y, t=theta: ref.nlj_count(x, y, t),
        lambda _, x=x, y=y, xn=xn, yn=yn, t2=th2: (
            (xn[:, None] + yn[None, :] - 2.0 * torch.matmul(x, y.T))
            .clamp_min(0.0) < t2).sum(1, dtype=torch.int32),
        (B * d + N * d) * 4 + B * 4, 2.0 * B * N * d)
    del x, y, xn, yn

    # every event median is taken; now the device times
    for r, key, fn in pending:
        ms = profiled_ms(torch, fn)
        r[key] = ms if ms > 0 else event_ms(torch, fn)
    mm_ms = mm["ms"]
    out["pairwise_sq_dists"]["mm_ms"] = mm_ms
    log(f"[kernels] pairwise_sq_dists: torch.mm (TF32 off) of the same "
        f"operands {mm_ms:.4f} ms, {mm['flops'] / mm_ms / 1e9:.1f} TFLOP/s; "
        f"the kernel {mm['flops'] / out['pairwise_sq_dists']['ms'] / 1e9:.1f}")
    e8 = out["pairwise_sq_dists_int8"]
    log(f"[kernels] pairwise_sq_dists_int8 at the streaming parent shape "
        f"{e8['parent_shape']}: max_abs_err={e8['parent_max_abs_err']} "
        f"ms={e8['parent_ms']:.4f} (events {e8['parent_event_ms']:.4f}) "
        f"bound_ms={e8['parent_bound_ms']:.4f} ({e8['parent_bound_by']})")
    g = out["gather_sq_dists"]
    log(f"[kernels] gather_sq_dists event ms a call: direct launch "
        f"{g['event_ms']:.4f}, through the custom op "
        f"{g['op_event_ms']:.4f} (+{(g['op_event_ms'] - g['event_ms']) * 1e3:.1f}"
        f" µs)")
    for name, r in out.items():
        off = (f" early exit off ms={r['ms_exit_off']:.4f} (events "
               f"{r['event_ms_exit_off']:.4f})" if "ms_exit_off" in r else "")
        comp = (f" composition_ms={r['composition_ms']:.4f} (events "
                f"{r['composition_event_ms']:.4f})"
                if "composition_ms" in r else "")
        log(f"[kernels] {name} {r['shape']}: max_abs_err={r['max_abs_err']} "
            f"ms={r['ms']:.4f} (events {r['event_ms']:.4f}){off} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']}"
            f"{comp}")
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


def card_keys(torch, pairs: np.ndarray, n_data: int):
    """Sorted unique int64 keys ``q·n_data + y`` of a (P, 2) pair array,
    computed on the card (the set comparisons below run over tens of
    millions of pairs)."""
    p = torch.as_tensor(np.ascontiguousarray(pairs, np.int64), device=DEV)
    if p.numel() == 0:
        return torch.empty(0, dtype=torch.int64, device=DEV)
    return torch.unique(p[:, 0] * n_data + p[:, 1])


def recalls(torch, found: np.ndarray, truth, n_data: int, n_query: int,
            cap: int) -> tuple[float, float]:
    """(recall, recall within the pool cap): the second divides by
    Σ_q min(|truth_q|, cap), the most a pool of ``cap`` slots can hold.
    ``truth`` is a pair array or its ``card_keys``."""
    t = truth if isinstance(truth, torch.Tensor) else card_keys(
        torch, truth, n_data)
    if t.numel() == 0:
        return 1.0, 1.0
    hit = int(torch.isin(card_keys(torch, found, n_data), t).sum())
    per_q = torch.bincount(t // n_data, minlength=n_query)
    return hit / t.numel(), hit / int(torch.clamp_max(per_q, cap).sum())


def sync_us(torch, n: int = 1000) -> float:
    """Host cost of one traversal-loop check (reduce + device→host bool)."""
    done = torch.zeros(256, dtype=torch.bool, device=DEV)
    bool(done.all())
    t0 = time.perf_counter()
    for _ in range(n):
        bool(done.all())
    return (time.perf_counter() - t0) / n * 1e6


def run_join(torch, ops, name: str, n_data: int, n_query: int,
             theta_idx: int, *, spec="default", base: dict | None = None,
             overlap_off: bool = True) -> dict:
    """Drive one path through ``make_engine(Y, spec).join`` with the
    default ``JoinConfig`` at θ = thresholds(ds, 7)[theta_idx]: build and
    join with the launch counts reset just before and read just after,
    soundness in float64, recall against the f32 exact NLJ, and (with
    ``overlap_off``) overlap off on the cached index with identical
    pairs. ``base`` is the f32 run of the same data: its dataset and exact
    pairs are reused."""
    from repro_torch.configs.vectorjoin import make_engine
    from repro_torch.core import JoinConfig, exact_join_pairs
    from repro_torch.core.graph import BuildStats
    from repro_torch.data.vectors import table1_dataset, thresholds

    t0 = time.perf_counter()
    ds = base["ds"] if base else table1_dataset(name, n_data=n_data,
                                                n_query=n_query, seed=0)
    theta = float(thresholds(ds, 7)[theta_idx])
    cfg = dataclasses.replace(JoinConfig(), theta=theta)
    eng = make_engine(ds.Y, spec, default=cfg, device=DEV)   # the card
    cfg = eng.default                                     # spec's quant
    tag = f"{name}/{cfg.quant}"
    knn: dict = {}
    bstats = BuildStats()
    # diagnostics the build fills in: its kNN lists and traffic counts
    eng.build_kw.update(knn_out=knn, build_stats=bstats)
    torch.cuda.synchronize()
    log(f"[{tag}] |Y|={n_data} |X|={n_query} d={ds.Y.shape[1]} "
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
    ms_iter = join_s / max(st.n_iters, 1) * 1e3
    log(f"[{tag}] build_s={eng.build_seconds:.2f} join_s={join_s:.2f} "
        f"pairs={len(res.pairs)} n_dist={st.n_dist} n_iters={st.n_iters} "
        f"n_ood={st.n_ood} n_overflow={st.n_overflow} "
        f"n_rerank={st.n_rerank} overflow_retries={st.overflow_retries} "
        f"n_rerank_gather={st.n_rerank_gather} waves={n_waves} "
        f"syncs_per_wave={st.n_iters / max(n_waves, 1):.1f} "
        f"ms_per_iter={ms_iter:.3f} peak_mem_GB={peak / 2**30:.2f} "
        f"build_counts={eng.build_counts} launches={launches}")
    if getattr(spec, "quant_build", "off") != "off":
        # the cascade build's kNN sweep, as the build counted and timed it
        b = bstats
        if b.knn_blocks <= 0:
            raise AssertionError(f"[{tag}] the cascade build reports no "
                                 f"bound block")
        log(f"[{tag}] cascade kNN sweep: {b.knn_blocks} bound blocks in "
            f"{b.knn_sweep_s:.2f} device s, "
            f"{b.knn_sweep_s / b.knn_blocks * 1e3:.2f} ms per bound block")
    if cfg.quant != "off":
        b = bstats
        log(f"[{tag}] build stats: knn_exact/row="
            f"{b.knn_exact / max(n_data + n_query, 1):.2f} "
            f"knn_exact={b.knn_exact} knn_pairs={b.knn_pairs} "
            f"prune_exact={b.prune_exact} prune_pairs={b.prune_pairs} "
            f"f32_saved_frac={b.f32_saved_frac:.6f}")

    pairs = res.pairs
    if (pairs.dtype != np.int64 or pairs.ndim != 2 or pairs.shape[1] != 2
            or not ((0 <= pairs[:, 0]) & (pairs[:, 0] < n_query)
                    & (0 <= pairs[:, 1]) & (pairs[:, 1] < n_data)).all()):
        raise AssertionError(f"{tag}: malformed pair array "
                             f"{pairs.dtype} {pairs.shape}")
    X = torch.as_tensor(ds.X, device=eng.Y.device)
    t1 = time.perf_counter()
    band = check_sound(torch, X, eng.Y, pairs, theta)
    sound_s = time.perf_counter() - t1
    nlj_s = None
    if base:
        truth = base["truth"]
    else:
        t0 = time.perf_counter()
        truth = exact_join_pairs(X, eng.Y, theta)
        torch.cuda.synchronize()
        nlj_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    truth_keys = card_keys(torch, truth, n_data)
    rec, rec_cap = recalls(torch, res.pairs, truth_keys, n_data, n_query,
                           cfg.traversal.pool_cap)
    recall_s = time.perf_counter() - t1
    log(f"[{tag}] sound (0 unsound; boundary band {band}) recall={rec:.6f} "
        f"recall_within_pool_cap={rec_cap:.6f} truth={len(truth)} "
        f"f32 nlj_s={nlj_s} (check seconds: sound {sound_s:.2f}, recall "
        f"{recall_s:.2f})")

    # the same join with overlap off, on the cached index: identical pairs
    seq_cfg = dataclasses.replace(cfg, overlap=False)
    if overlap_off:
        t0 = time.perf_counter()
        seq = eng.join(ds.X, seq_cfg)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        if not torch.equal(card_keys(torch, seq.pairs, n_data),
                           card_keys(torch, res.pairs, n_data)):
            raise AssertionError(f"{tag}: overlap on/off pair sets differ")
        log(f"[{tag}] overlap on join_s={join_s:.2f} off join_s={seq_s:.2f} "
            f"(identical pairs) ms_per_iter on {ms_iter:.3f} off "
            f"{seq_s / max(seq.stats.n_iters, 1) * 1e3:.3f}")
    merged = eng.merged_index(ds.X)
    return dict(recall=rec, launches=launches, n_ood=st.n_ood, pairs=pairs,
                n_dist=st.n_dist, n_iters=st.n_iters,
                build_s=eng.build_seconds, join_s=join_s,
                eng=eng, X=ds.X, cfg=seq_cfg, name=tag, ds=ds, truth=truth,
                truth_keys=truth_keys,
                theta=theta, knn={k: v.cpu() for k, v in knn.items()},
                nbrs=merged.nbrs.cpu(), ms_iter=ms_iter)


def check_knn_ties(run: dict, base: dict) -> None:
    """The sq8 build's kNN lists equal the f32 build's, except rows where
    the two kept different entries tied at exactly the k-th distance
    (the f32 sweep's per-block cut keeps any of them); then the pruned
    neighbor tables are compared row by row."""
    d8, i8 = run["knn"]["dists"], run["knn"]["ids"]
    d32, i32 = base["knn"]["dists"], base["knn"]["ids"]
    rows = (i8 != i32).any(dim=1).nonzero().squeeze(1)
    for r in rows.tolist():
        if not bool((d8[r] == d32[r]).all()):
            raise AssertionError(f"{run['name']}: kNN row {r} distances "
                                 f"differ from the f32 build's")
        pos = (i8[r] != i32[r]).nonzero().squeeze(1)
        if not bool((d8[r, pos] == d8[r, -1]).all()):
            raise AssertionError(f"{run['name']}: kNN row {r} differs "
                                 f"away from a tie at the k-th distance")
    if not bool((d8 == d32).all()):
        raise AssertionError(f"{run['name']}: kNN distances differ from "
                             f"the f32 build's")
    nb_rows = int((run["nbrs"] != base["nbrs"]).any(dim=1).sum())
    log(f"[{run['name']}] kNN lists equal to the f32 build's but for "
        f"{rows.numel()} rows tied at the k-th distance; neighbor table "
        f"rows that differ: {nb_rows} of {run['nbrs'].shape[0]}")
    if nb_rows and not rows.numel():
        raise AssertionError(f"{run['name']}: neighbor tables differ with "
                             f"identical kNN lists")


def check_nlj(torch, ops, run: dict, kernels, *, mode: str | None = None,
              early_exit: bool = True) -> dict:
    """``method="nlj"`` under ``mode`` (the engine's own by default) gives
    the f32 NLJ's pairs, except pairs whose float64 distance lies within
    16 f32 ulps of θ (counted): the f32 NLJ decides by the matmul form,
    whose rounding near θ is of that order at these norms, the cascade
    NLJ by certified bounds and the difference form. The NLJ's seconds
    exclude any tier store the call built over Y alone (the first NLJ of
    each tier builds one), which are logged apart. Returns the pairs, the
    stats, the launches and the seconds."""
    eng, ds = run["eng"], run["ds"]
    cfg = eng.default
    if mode is not None:
        cfg = dataclasses.replace(cfg, quant=mode)
    cfg = dataclasses.replace(cfg, method="nlj", traversal=dataclasses.replace(
        cfg.traversal, early_exit=early_exit))
    tag = f"{run['name'].split('/')[0]}/{cfg.quant}"
    n = ds.Y.shape[0]
    builds0, bs0 = dict(eng.build_counts), eng.build_seconds
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.join(ds.X, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    store_s = eng.build_seconds - bs0
    nlj_s = wall - store_s
    new_builds = {k: v - builds0[k] for k, v in eng.build_counts.items()
                  if v != builds0[k]}
    t1 = time.perf_counter()
    got, want = card_keys(torch, res.pairs, n), run["truth_keys"]
    only_got = got[~torch.isin(got, want)]
    diff = torch.cat([only_got, want[~torch.isin(want, got)]])
    theta = np.float32(run["theta"])
    ulp = float(np.spacing(theta))
    worst = 0.0
    if diff.numel():
        q, y = diff // n, diff % n
        X = torch.as_tensor(ds.X, device=DEV)
        d64 = ((X[q].double() - eng.Y[y].double()) ** 2).sum(1).sqrt()
        off = (d64 - float(theta)).abs() / ulp
        worst = float(off.max())
        if worst > 16:
            raise AssertionError(f"{tag} nlj: {int((off > 16).sum())} pairs "
                                 f"differ from the f32 NLJ more than 16 ulps "
                                 f"of θ away (worst {worst:.1f})")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} nlj never launched {missing}")
    extra = only_got.numel()
    st = res.stats
    log(f"[{tag}] nlj (early exit {'on' if early_exit else 'off'}): "
        f"{len(res.pairs)} pairs in {nlj_s:.2f}s (stores_s={store_s:.2f}, "
        f"new builds {new_builds}, outside it), n_rerank={st.n_rerank}, "
        f"n_esc8={st.n_esc8}, dims_scanned_frac={st.dims_scanned_frac:.4f}, "
        f"equal to the f32 NLJ but for {diff.numel()} pairs within 16 ulps "
        f"of θ ({extra} only in {cfg.quant}, {diff.numel() - extra} only in "
        f"f32; farthest {worst:.2f} ulps; compared in "
        f"{time.perf_counter() - t1:.2f}s); launches={launches}")
    return dict(pairs=got, stats=st, launches=launches, seconds=nlj_s)


def run_mode(torch, ops, run: dict, mode: str, *, floor: float, kernels,
             nlj_kernels, reruns: bool = True) -> dict:
    """Phases 4b/5b: the merged-index join and the NLJ under ``mode`` on
    the engine and merged index of an earlier sq8 run (no second index
    build; the int8 store is shared, the sketch/PDX stores are built once).
    Checks: the launch counts of ``kernels`` (reset just before, read just
    after), every pair sound in float64, recall against the f32 NLJ at
    least ``floor``, escalations under a sketch tier; then (with
    ``reruns``) the same pairs with overlap off and (PDX) with early exit
    off;
    and the NLJ (PDX tier
    0: on and off, the same pairs and n_rerank, and fewer dimensions
    scanned than a full scan)."""
    from repro_torch.quant.cascade import TIERS_BY_MODE
    eng, ds = run["eng"], run["ds"]
    n_data, n_query = ds.Y.shape[0], ds.X.shape[0]
    cfg = dataclasses.replace(eng.default, quant=mode)
    tag = f"{run['name'].split('/')[0]}/{mode}"
    builds0, bs0 = dict(eng.build_counts), eng.build_seconds
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.join(ds.X, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    store_s = eng.build_seconds - bs0
    join_s = wall - store_s
    st = res.stats
    new_builds = {k: v - builds0[k] for k, v in eng.build_counts.items()
                  if v != builds0[k]}
    names = TIERS_BY_MODE[mode]
    # the share of candidates a sketch tier pruned, where the mode has one
    pruned = (f"sketch_pruned_frac={1 - st.n_esc8 / max(st.n_dist, 1):.4f} "
              if "sketch1" in names else "")
    log(f"[{tag}] stores_s={store_s:.2f} (new builds {new_builds}) "
        f"join_s={join_s:.2f} pairs={len(res.pairs)} n_dist={st.n_dist} "
        f"n_iters={st.n_iters} n_esc8={st.n_esc8} {pruned}"
        f"n_rerank={st.n_rerank} overflow_retries={st.overflow_retries} "
        f"dims_scanned_frac={st.dims_scanned_frac:.4f} "
        f"n_overflow={st.n_overflow} n_ood={st.n_ood} "
        f"ms_per_iter={join_s / max(st.n_iters, 1) * 1e3:.3f} "
        f"quant_bytes={st.quant_bytes} launches={launches}")
    if "merged" in new_builds:
        raise AssertionError(f"{tag}: the merged index was built again")
    pairs = res.pairs
    if (pairs.dtype != np.int64 or pairs.ndim != 2 or pairs.shape[1] != 2
            or not ((0 <= pairs[:, 0]) & (pairs[:, 0] < n_query)
                    & (0 <= pairs[:, 1]) & (pairs[:, 1] < n_data)).all()):
        raise AssertionError(f"{tag}: malformed pair array")
    X = torch.as_tensor(ds.X, device=eng.Y.device)
    band = check_sound(torch, X, eng.Y, pairs, run["theta"])
    rec, rec_cap = recalls(torch, pairs, run["truth_keys"], n_data, n_query,
                           cfg.traversal.pool_cap)
    log(f"[{tag}] sound (0 unsound; boundary band {band}) recall={rec:.6f} "
        f"recall_within_pool_cap={rec_cap:.6f} (floor {floor})")
    if rec < floor:
        raise AssertionError(f"{tag}: recall {rec} below the floor {floor}")
    if "sketch1" in names and st.n_esc8 <= 0:
        raise AssertionError(f"{tag}: no candidate escalated past the sketch")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} path never launched {missing}")
    bare = [k for k in FUSED_AWAY if launches[k]]
    if bare:
        raise AssertionError(f"{tag} join launched the bare {bare}")

    want = card_keys(torch, pairs, n_data)
    variants = ([("overlap off", dataclasses.replace(cfg, overlap=False))]
                if reruns else [])
    if "pdx" in names and reruns:
        variants.append(("early exit off", dataclasses.replace(
            cfg, traversal=dataclasses.replace(cfg.traversal,
                                               early_exit=False))))
    reranks = [st.n_rerank]
    for label, c in variants:
        t0 = time.perf_counter()
        r2 = eng.join(ds.X, c)
        torch.cuda.synchronize()
        if not torch.equal(card_keys(torch, r2.pairs, n_data), want):
            raise AssertionError(f"{tag}: {label} changes the pairs")
        reranks.append(r2.stats.n_rerank)
        log(f"[{tag}] {label}: identical pairs ({want.numel()}) in "
            f"{time.perf_counter() - t0:.2f}s, "
            f"n_rerank={r2.stats.n_rerank}, dims_scanned_frac="
            f"{r2.stats.dims_scanned_frac:.4f}")
    if len(set(reranks)) > 1:
        raise AssertionError(f"{tag}: n_rerank differs with overlap or "
                             f"early exit off {reranks}")

    nlj = check_nlj(torch, ops, run, nlj_kernels, mode=mode)
    # the NLJ sweep of a PDX tier 0 must retire lanes mid-vector; the
    # join's band re-rank sees only pairs near θ and may scan them all.
    # (Under a sketch tier 0 the NLJ exits early nowhere: no repeat.)
    if names[0] == "pdx" and not nlj["stats"].dims_scanned_frac < 1:
        raise AssertionError(f"{tag} nlj: the PDX sweep exited early nowhere")
    if names[0] == "pdx":
        off = check_nlj(torch, ops, run, nlj_kernels, mode=mode,
                        early_exit=False)
        if not (torch.equal(off["pairs"], nlj["pairs"])
                and off["stats"].n_rerank == nlj["stats"].n_rerank):
            raise AssertionError(f"{tag} nlj: pairs or n_rerank differ with "
                                 f"early exit off")
        log(f"[{tag}] nlj early exit on/off: identical pairs and n_rerank; "
            f"seconds on {nlj['seconds']:.2f} off {off['seconds']:.2f}")
    return dict(name=tag, recall=rec, launches=launches,
                nlj_launches=nlj["launches"], join_s=join_s,
                band_frac=st.n_rerank / (n_query * cfg.traversal.pool_cap))


# ---------------------------------------------------------------------------
# phase 3b: the NLJ count of the exact NLJ, and the search path
# ---------------------------------------------------------------------------

def check_nlj_count_main(torch, ops, run: dict) -> dict:
    """``ops.nlj_count`` over all the main path's queries in one call must
    give, per query, the count of the exact NLJ's pairs: both compare the
    same tile arithmetic with θ². Where a query's norm is summed another
    way (the NLJ takes the norms of 512-row blocks, the count of the whole
    query set), its count may differ, by at most its pairs within 16 f32
    ulps of θ in float64; which case held is logged. Returns the
    launches."""
    eng, ds = run["eng"], run["ds"]
    n_data, n_query = ds.Y.shape[0], ds.X.shape[0]
    X = torch.as_tensor(ds.X, device=DEV)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = ops.nlj_count(X, eng.Y, theta=run["theta"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    if launches["nlj_count"] == 0:
        raise AssertionError("the NLJ count check never launched nlj_count")
    want = torch.bincount(run["truth_keys"] // n_data, minlength=n_query)
    rows = (got.long() != want).nonzero().squeeze(1)
    theta = np.float32(run["theta"])
    ulp = float(np.spacing(theta))
    Y64 = eng.Y.double() if rows.numel() else None
    for q in rows.tolist():
        d64 = ((Y64 - X[q].double()) ** 2).sum(1).sqrt()
        band = int(((d64 - float(theta)).abs() <= 16 * ulp).sum())
        if abs(int(got[q]) - int(want[q])) > band:
            raise AssertionError(f"nlj_count: query {q} counts {int(got[q])} "
                                 f"pairs, the exact NLJ {int(want[q])}, "
                                 f"beyond its {band} pairs within 16 ulps")
    case = ("equal for every query" if not rows.numel() else
            f"{rows.numel()} queries differ, each by at most its pairs "
            f"within 16 ulps of θ")
    log(f"[sift-like] nlj_count over {n_query} queries in one launch "
        f"({secs:.3f}s): {int(got.sum())} pairs against the exact NLJ's "
        f"{int(want.sum())}: {case}")
    return launches


# the search path's kernels: the first join builds G_Y and G_X (kNN and
# prune: pairwise, top-k merge; mean_nbr_dist: rowwise), the caching
# methods' MST takes its star keys with rowwise and its edges with gather,
# every traversal probes with gather; under sq8 the probes go through the
# int8 gather bounds and the band re-rank through the f32 gather
SEARCH_KERNELS = ("pairwise_sq_dists", "topk_merge", "gather_sq_dists",
                  "rowwise_sq_dists")
CACHING_KERNELS = ("gather_sq_dists", "rowwise_sq_dists")
SEARCH_SQ8_KERNELS = ("gather_bounds_int8", "gather_sq_dists",
                      "rowwise_sq_dists")
# (method, kernels its join must launch, queries it runs on)
SEARCH_RUNS = (("es_sws", SEARCH_KERNELS, SEARCH_CUT),
               ("es", ("gather_sq_dists",), SEARCH_CUT),
               ("index", ("gather_sq_dists",), SEARCH_CUT))
CACHE_FIELDS = ("cache_hits", "cache_misses", "cache_evictions",
                "peak_cache_entries")


def search_join(torch, ops, run: dict, cfg, kernels, floor: float,
                n_q: int | None = None) -> dict:
    """One search-path join on the main engine over its first ``n_q``
    queries (all by default), with the launch counts reset just before and read just
    after: sound in float64, recall against the f32 NLJ at least
    ``floor``, the path's kernels launched. Logs the builds it made, the
    greedy/expand split of n_iters, ms per iteration and the cache
    counters."""
    from repro_torch.core import traversal
    eng, ds = run["eng"], run["ds"]
    n_data = ds.Y.shape[0]
    n_q = ds.X.shape[0] if n_q is None else n_q
    tag = (f"sift-like/{cfg.method}"
           + (f"/{cfg.quant}" if cfg.quant != "off" else "")
           + ("" if cfg.overlap else " overlap off"))
    builds0, bs0 = dict(eng.build_counts), eng.build_seconds
    greedy = traversal.greedy_search
    n_greedy = 0

    def counted(*a, **kw):
        nonlocal n_greedy
        g = greedy(*a, **kw)
        n_greedy += g.n_iters
        return g
    traversal.greedy_search = counted
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = eng.join(ds.X[:n_q], cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        traversal.greedy_search = greedy
    build_s = eng.build_seconds - bs0
    join_s = wall - build_s
    st = res.stats
    new_builds = {k: v - builds0[k] for k, v in eng.build_counts.items()
                  if v != builds0[k]}
    log(f"[{tag}] queries={n_q} new builds {new_builds} "
        f"build_s={build_s:.2f} join_s={join_s:.2f} pairs={len(res.pairs)} "
        f"n_dist={st.n_dist} n_iters={st.n_iters} (greedy {n_greedy}, "
        f"expand {st.n_iters - n_greedy}) "
        f"ms_per_iter={join_s / max(st.n_iters, 1) * 1e3:.3f} "
        f"greedy_s={st.greedy_seconds:.2f} expand_s={st.expand_seconds:.2f} "
        + " ".join(f"{f}={getattr(st, f)}" for f in CACHE_FIELDS)
        + f" n_overflow={st.n_overflow} n_rerank={st.n_rerank} "
        f"overflow_retries={st.overflow_retries} launches={launches}")
    pairs = res.pairs
    if (pairs.dtype != np.int64 or pairs.ndim != 2 or pairs.shape[1] != 2
            or not ((0 <= pairs[:, 0]) & (pairs[:, 0] < n_q)
                    & (0 <= pairs[:, 1]) & (pairs[:, 1] < n_data)).all()):
        raise AssertionError(f"{tag}: malformed pair array")
    Xt = torch.as_tensor(ds.X, device=DEV)
    band = check_sound(torch, Xt, eng.Y, pairs, run["theta"])
    truth = run["truth_keys"]
    rec, rec_cap = recalls(torch, pairs, truth[truth < n_q * n_data], n_data,
                           n_q, cfg.traversal.pool_cap)
    log(f"[{tag}] sound (0 unsound; boundary band {band}) recall={rec:.6f} "
        f"recall_within_pool_cap={rec_cap:.6f} (floor {floor})")
    if rec < floor:
        raise AssertionError(f"{tag}: recall {rec} below the floor {floor}")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag} path never launched {missing}")
    return dict(name=tag, res=res, launches=launches, recall=rec,
                join_s=join_s, n_q=n_q, n_greedy=n_greedy,
                keys=card_keys(torch, pairs, n_data), new_builds=new_builds)


def run_search(torch, ops, run: dict) -> dict:
    """Phase 3b: es_sws (building G_Y and their G_X), es and index on
    the first SEARCH_CUT queries, and on the first MST_CUT (one more
    G_X): es_sws with overlap on and off (the same pairs and cache
    counters), es_hws, and es_sws under sq8 on the same G_Y (an int8 store
    over its rows, no second graph build); all on the f32 main engine, its
    Y, θ and exact NLJ reused. Returns the runs by path name."""
    from repro_torch.core import JoinConfig
    eng = run["eng"]
    for k in ("knn_out", "build_stats"):     # the merged build's diagnostics
        eng.build_kw.pop(k, None)
    base = dataclasses.replace(JoinConfig(), theta=run["theta"])
    runs = {}
    for method, kernels, n_q in SEARCH_RUNS:
        if n_q < MAIN_N_QUERY:
            log(f"[sift-like/{method}] runs on the first {n_q} of "
                f"{MAIN_N_QUERY} queries (the smoke's time limit)")
        runs[method] = search_join(
            torch, ops, run, dataclasses.replace(base, method=method),
            kernels, SEARCH_RECALL_FLOORS[method], n_q)
    if runs["es_sws"]["new_builds"] != {"index_y": 1, "index_x": 1}:
        raise AssertionError(f"es_sws built {runs['es_sws']['new_builds']}, "
                             f"not one G_Y and one G_X")
    if any(r["new_builds"] for m, r in runs.items() if m != "es_sws"):
        raise AssertionError("a later search join built an index again")

    # on the first MST_CUT queries (the smoke's time limit): es_sws with
    # overlap on builds their G_X; overlap off, es_hws and sq8 reuse it
    sws_cfg = dataclasses.replace(base, method="es_sws")
    sws, off, hws = (
        search_join(torch, ops, run, cfg, CACHING_KERNELS,
                    SEARCH_RECALL_FLOORS[cfg.method], MST_CUT)
        for cfg in (sws_cfg, dataclasses.replace(sws_cfg, overlap=False),
                    dataclasses.replace(base, method="es_hws")))
    builds = [r["new_builds"] for r in (sws, off, hws)]
    if builds != [{"index_x": 1}, {}, {}]:
        raise AssertionError(f"es_sws on/off and es_hws built {builds}, "
                             f"not one G_X")
    runs["es_hws"] = hws
    fields = ("n_dist", "n_iters") + CACHE_FIELDS
    if not (torch.equal(off["keys"], sws["keys"])
            and all(getattr(off["res"].stats, f)
                    == getattr(sws["res"].stats, f) for f in fields)):
        raise AssertionError("es_sws: overlap off changes the pairs or the "
                             "cache counters")
    log(f"[sift-like/es_sws] overlap on/off over the first {MST_CUT} "
        f"queries: identical pairs, n_dist, n_iters and cache counters; "
        f"join_s on {sws['join_s']:.2f} off {off['join_s']:.2f}")

    sq8 = search_join(torch, ops, run, dataclasses.replace(
        base, method="es_sws", quant="sq8"), SEARCH_SQ8_KERNELS,
        SEARCH_RECALL_FLOORS["es_sws/sq8"], MST_CUT)
    if sq8["new_builds"] != {"quant": 1}:
        raise AssertionError(f"es_sws/sq8 built {sq8['new_builds']}, not "
                             f"one int8 store over G_Y's rows")
    runs["es_sws/sq8"] = sq8
    per_q = " ".join(f"{m} {r['res'].stats.n_dist} "
                     f"({r['res'].stats.n_dist / r['n_q']:.1f}/query)"
                     for m, r in runs.items())
    log(f"[sift-like] n_dist: {per_q} es_mi_adapt {run['n_dist']} "
        f"({run['n_dist'] / MAIN_N_QUERY:.1f}/query)")
    log(f"[sift-like] recall: " + " ".join(
        f"{m} {r['recall']:.6f}" for m, r in runs.items())
        + f" es_mi_adapt {run['recall']:.6f}")
    return runs


# ---------------------------------------------------------------------------
# phases 3c and 5c: the streaming engine
# ---------------------------------------------------------------------------

# phase 3c streams the first SEARCH_CUT queries in batches of STREAM_BATCH;
# the mixed batch is an nlj and an es batch of MIXED_BATCH queries each
STREAM_BATCH = 500
MIXED_BATCH = 256
# recall floors of the streamed es_sws, f32 and sq8: measured on an H100
# (PERF.md) minus 0.05
STREAM_RECALL_FLOORS = {"stream/es_sws": 0.936, "stream/es_sws/sq8": 0.912}
# the kernels each streamed path must launch: the f32 traversal's gather;
# under sq8 also the parent choice (#6), the LSH cap estimate (#8) and the
# int8 probes; the nlj batch's pairwise block; the MI batches' merged
# sq8 builds and joins
STREAM_KERNELS = ("gather_sq_dists",)
STREAM_SQ8_KERNELS = ("pairwise_sq_dists_int8", "pairwise_hamming",
                      "gather_bounds_int8", "gather_sq_dists")
STREAM_NLJ_KERNELS = ("pairwise_sq_dists", "gather_sq_dists")
STREAM_MI_KERNELS = SQ8_KERNELS + ("pairwise_hamming",)
STREAM_FIELDS = ("n_dist", "n_iters", "cache_evictions", "cache_tombstones")


def launched(launches: dict) -> dict:
    """The kernels a path launched, with their counts."""
    return {k: v for k, v in launches.items() if v}


def stream_state(eng) -> tuple:
    """The engine's carried state: the work-sharing cache and the carry
    window's query ids."""
    return ({int(k): v.tolist() for k, v in eng._stream_cache.items()},
            eng._stream_entry_n, eng._carry_qids.tolist())


def stream_pass(torch, ops, run: dict, cfg, batches, tag: str, *,
                many: bool = False) -> dict:
    """One stream of ``batches`` through ``submit`` (or one
    ``submit_many``) on the main engine after ``reset_stream``, with the
    launch counts reset just before and read just after: pairs (global
    ids) sound in float64, recall against the f32 NLJ restricted to the
    streamed queries. Returns the per-batch results, the pair keys, the
    carried state and the launches."""
    eng, ds = run["eng"], run["ds"]
    n_data = ds.Y.shape[0]
    n_q = sum(len(b) for b in batches)
    eng.reset_stream()
    bs0 = eng.build_seconds
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if many:
        res = eng.submit_many([(b, cfg) for b in batches])
    else:
        res = [eng.submit(b, cfg) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    pairs = np.concatenate([r.pairs for r in res])
    tot = {f: sum(getattr(r.stats, f) for r in res)
           for f in STREAM_FIELDS + ("overflow_retries", "n_rerank",
                                     "cache_hits", "cache_misses")}
    log(f"[{tag}] {len(batches)} batches of {len(batches[0])}: "
        f"wall_s={wall:.2f} (estimate/build s {eng.build_seconds - bs0:.2f}) "
        f"pairs={len(pairs)} "
        + " ".join(f"{k}={v}" for k, v in tot.items())
        + f" per-batch n_dist {[r.stats.n_dist for r in res]} "
        f"n_submitted={eng.n_submitted} launches={launched(launches)}")
    if eng.n_submitted != n_q:
        raise AssertionError(f"{tag}: n_submitted {eng.n_submitted} != {n_q}")
    if len(pairs) and not ((pairs[:, 0] < n_q).all()
                           and (pairs[:, 1] < n_data).all()):
        raise AssertionError(f"{tag}: pair ids out of range")
    Xt = torch.as_tensor(ds.X[:n_q], device=DEV)
    band = check_sound(torch, Xt, eng.Y, pairs, run["theta"])
    truth = run["truth_keys"]
    rec, _ = recalls(torch, pairs, truth[truth < n_q * n_data], n_data, n_q,
                     cfg.traversal.pool_cap)
    log(f"[{tag}] sound (0 unsound; boundary band {band}) recall={rec:.6f}")
    return dict(res=res, keys=card_keys(torch, pairs, n_data), wall=wall,
                state=stream_state(eng), launches=launches, recall=rec,
                name=tag)


def same_stream(torch, a: dict, b: dict, fields=STREAM_FIELDS) -> bool:
    """Two streams gave the same pairs, per-batch counters and state."""
    return (torch.equal(a["keys"], b["keys"]) and a["state"] == b["state"]
            and all(getattr(x.stats, f) == getattr(y.stats, f)
                    for x, y in zip(a["res"], b["res"], strict=True)
                    for f in fields))


def run_stream(torch, ops, run: dict) -> dict:
    """Phase 3c on the f32 main engine (its G_Y, its int8 store over G_Y
    and the exact NLJ of phase 3b reused): es_sws streamed over the first
    SEARCH_CUT queries with overlap on, then off (the same pairs,
    counters, cache and carry), the same batches through one
    ``submit_many`` (the same again), a mixed nlj + es stream (the nlj
    batch is the exact NLJ of its queries), and es_sws under sq8, whose
    parents come from #6 and whose band cap from the LSH estimate (#8).
    Returns the paths' launches."""
    from repro_torch.core import JoinConfig
    eng, ds = run["eng"], run["ds"]
    n_data = ds.Y.shape[0]
    base = dataclasses.replace(JoinConfig(), theta=run["theta"],
                               method="es_sws")
    batches = [ds.X[b0:b0 + STREAM_BATCH]
               for b0 in range(0, SEARCH_CUT, STREAM_BATCH)]
    on = stream_pass(torch, ops, run, base, batches, "stream/es_sws")
    off = stream_pass(torch, ops, run, dataclasses.replace(
        base, overlap=False), batches, "stream/es_sws overlap off")
    if not same_stream(torch, on, off):
        raise AssertionError("stream/es_sws: overlap off changes the pairs, "
                             "the counters or the carried state")
    many = stream_pass(torch, ops, run, base, batches,
                       "stream/es_sws submit_many", many=True)
    if not same_stream(torch, on, many):
        raise AssertionError("stream/es_sws: submit_many differs from "
                             "sequential submit")
    log(f"[stream/es_sws] overlap on/off and submit_many: identical pairs, "
        f"{', '.join(STREAM_FIELDS)}, cache and carry; wall_s on "
        f"{on['wall']:.2f} off {off['wall']:.2f} submit_many "
        f"{many['wall']:.2f}")

    # mixed: an nlj batch, then an es batch
    eng.reset_stream()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    nlj = eng.submit(ds.X[:MIXED_BATCH], base, method="nlj")
    es = eng.submit(ds.X[MIXED_BATCH:2 * MIXED_BATCH], base, method="es")
    torch.cuda.synchronize()
    mixed_s = time.perf_counter() - t0
    mixed_launches = ops.launch_counts()
    truth = run["truth_keys"]
    want = truth[truth < MIXED_BATCH * n_data]
    got = card_keys(torch, nlj.pairs, n_data)
    diff = torch.cat([got[~torch.isin(got, want)],
                      want[~torch.isin(want, got)]])
    if diff.numel():
        # only pairs within 16 f32 ulps of θ may fall the other way
        q, y = diff // n_data, diff % n_data
        Xt = torch.as_tensor(ds.X, device=DEV)
        d64 = ((Xt[q].double() - eng.Y[y].double()) ** 2).sum(1).sqrt()
        th = float(np.float32(run["theta"]))
        if bool(((d64 - th).abs() > 16 * float(np.spacing(np.float32(th))))
                .any()):
            raise AssertionError("stream/nlj: the nlj batch differs from the "
                                 "exact NLJ beyond θ's 16-ulp band")
    es_pairs = es.pairs
    if len(es_pairs) and not ((es_pairs[:, 0] >= MIXED_BATCH).all()
                              and (es_pairs[:, 0] < 2 * MIXED_BATCH).all()):
        raise AssertionError("stream/nlj: the es batch's ids are not global")
    band = check_sound(torch, torch.as_tensor(ds.X, device=DEV), eng.Y,
                       es_pairs, run["theta"])
    log(f"[stream/nlj] nlj batch of {MIXED_BATCH}: {len(nlj.pairs)} pairs, "
        f"the exact NLJ's {want.numel()} (differing within θ's 16-ulp band: "
        f"{diff.numel()}); es batch ids {MIXED_BATCH}..{2 * MIXED_BATCH - 1}:"
        f" {len(es_pairs)} sound pairs (boundary band {band}); wall_s "
        f"{mixed_s:.2f} launches={launched(mixed_launches)}")

    sq8 = stream_pass(torch, ops, run, dataclasses.replace(base, quant="sq8"),
                      batches, "stream/es_sws/sq8")
    log(f"[stream/es_sws/sq8] band cap estimates {eng._cap_estimates}")
    paths = {"stream/es_sws": (on, STREAM_KERNELS),
             "stream/es_sws/sq8": (sq8, STREAM_SQ8_KERNELS),
             "stream/nlj": (dict(launches=mixed_launches, name="stream/nlj"),
                            STREAM_NLJ_KERNELS)}
    for name, (r, kernels) in paths.items():
        check_launched(r, kernels)
        if name in STREAM_RECALL_FLOORS \
                and r["recall"] < STREAM_RECALL_FLOORS[name]:
            raise AssertionError(f"{name}: recall {r['recall']} below the "
                                 f"floor {STREAM_RECALL_FLOORS[name]}")
    eng.reset_stream()
    return {n: r["launches"] for n, (r, _) in paths.items()}


def run_stream_mi(torch, ops, run: dict) -> dict:
    """Phase 5c on the OOD sq8 engine: es_mi_adapt under sq8 streamed in
    two batches of half the queries, each building its own merged index
    (sq8 cascade build); each batch's pairs equal ``join`` of its queries
    (on the cached index, its band cap not seeded) shifted by the offset.
    Returns the launches of the two submits."""
    eng, ds = run["eng"], run["ds"]
    for k in ("knn_out", "build_stats"):     # the merged build's diagnostics
        eng.build_kw.pop(k, None)
    n_data, n_q = ds.Y.shape[0], ds.X.shape[0]
    half = n_q // 2
    batches = [ds.X[:half], ds.X[half:]]
    cfg = eng.default
    tag = f"stream/{cfg.method}/{cfg.quant}"
    builds0, bs0 = dict(eng.build_counts), eng.build_seconds
    eng.reset_stream()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = [eng.submit(b, cfg) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    build_s = eng.build_seconds - bs0
    new_builds = {k: v - builds0[k] for k, v in eng.build_counts.items()
                  if v != builds0[k]}
    log(f"[{run['name']}/{tag}] 2 batches of {half}: build_s={build_s:.2f} "
        f"join_s={wall - build_s:.2f} pairs "
        f"{[len(r.pairs) for r in res]} n_dist "
        f"{[r.stats.n_dist for r in res]} n_ood "
        f"{[r.stats.n_ood for r in res]} overflow_retries "
        f"{[r.stats.overflow_retries for r in res]} new builds "
        f"{new_builds} band cap estimates {eng._cap_estimates} "
        f"launches={launched(launches)}")
    if new_builds.get("merged") != 2:
        raise AssertionError(f"{tag}: built {new_builds}, not one merged "
                             f"index a batch")
    retries = []
    for i, (b, r) in enumerate(zip(batches, res)):
        t0 = time.perf_counter()
        alone = eng.join(b, cfg)
        torch.cuda.synchronize()
        shifted = alone.pairs.copy()
        shifted[:, 0] += i * half
        if not (torch.equal(card_keys(torch, r.pairs, n_data),
                            card_keys(torch, shifted, n_data))
                and r.stats.n_dist == alone.stats.n_dist):
            raise AssertionError(f"{tag}: batch {i} differs from join of its "
                                 f"queries shifted by {i * half}")
        retries.append((r.stats.overflow_retries,
                        alone.stats.overflow_retries))
        log(f"[{run['name']}/{tag}] batch {i}: {len(r.pairs)} pairs = join "
            f"+ {i * half} ({time.perf_counter() - t0:.2f}s)")
    pairs = np.concatenate([r.pairs for r in res])
    band = check_sound(torch, torch.as_tensor(ds.X, device=DEV), eng.Y,
                       pairs, run["theta"])
    rec, _ = recalls(torch, pairs, run["truth_keys"], n_data, n_q,
                     cfg.traversal.pool_cap)
    log(f"[{run['name']}/{tag}] sound (0 unsound; boundary band {band}) "
        f"recall={rec:.6f}; overflow_retries (submit, join) per batch "
        f"{retries}: the cap seed changes retries, not pairs")
    r = dict(launches=launches, name=tag)
    check_launched(r, STREAM_MI_KERNELS)
    eng.reset_stream()
    return launches


# ---------------------------------------------------------------------------
# phase 3d: the serving path
# ---------------------------------------------------------------------------

SERVE_BUCKETS = (64, 128, 256)
# halved from 48 for the smoke's time limit (PERF.md §4, §7)
SERVE_REQUESTS = 24
# requests draw their queries from the first SERVE_SPAN of each tenant's
SERVE_SPAN = 1_024
SERVE_MAX = 256
SERVE_SEED = 20
# recall floors per (tenant, quant) of the requests at budget 1.0:
# measured on an H100 (PERF.md) minus 0.05
SERVE_RECALL_FLOORS = {("sift", "off"): 0.937, ("sift", "sq8"): 0.912,
                       ("laion", "off"): 0.025, ("laion", "sq8"): 0.018}
# the kernels each tenant's path (warmup and serving) must launch: the
# f32 probes (#3); under sq8 the int8 parents (#6), the int8 probes (#7′)
# and the LSH cap estimate (#8)
SERVE_KERNELS = ("gather_sq_dists", "pairwise_sq_dists_int8",
                 "gather_bounds_int8", "pairwise_hamming")
SERVE_FIELDS = ("n_dist", "n_iters")


def add_launches(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def serve_requests(data: dict) -> list:
    """SERVE_REQUESTS requests from a fixed seed: tenants alternate, the
    quants alternate in pairs within a tenant (so sq8 waves meet a carry
    window of int8 codes), sizes 1..SERVE_MAX from the first SERVE_SPAN
    queries; a quarter at recall budget 0.5, two left to the planner.
    Returns (request, first query index) pairs."""
    from repro_torch.serve import JoinRequest
    rng = np.random.default_rng(SERVE_SEED)
    out = []
    for uid in range(SERVE_REQUESTS):
        name = ("sift", "laion")[uid % 2]
        ds, theta = data[name]
        n = int(rng.integers(1, SERVE_MAX + 1))
        lo = int(rng.integers(0, SERVE_SPAN - n + 1))
        r = JoinRequest(uid=uid, tenant=name, X=ds.X[lo:lo + n], theta=theta,
                        method="es_sws", quant=("off", "sq8")[(uid // 4) % 2])
        if uid % 4 == 3:
            r.recall_budget = 0.5
        if uid % 24 in (5, 10):               # two a tenant
            r.method = r.quant = None
        out.append((r, lo))
    return out


def run_serve(torch, ops, run: dict) -> dict:
    """Phase 3d: ``JoinService`` at full width on two tenants — ``sift``,
    the main engine's 1M x 128 card tensor (no copy) with phase 3b's G_Y
    installed, and ``laion``, the laion-like data of phase 5, whose G_Y
    its first warmup builds. Warm each at its θ (es_sws; off and sq8),
    serve SERVE_REQUESTS requests plus two bad ones (a wave off the ladder,
    the wrong width: rejected and counted), then hold the served results
    to a direct replay (``reset_stream``, ``submit(X, svc.plan(req))`` in
    dispatch order): the same pairs, ``qid_offset``, ``n_dist`` and
    ``n_iters``; every pair sound in float64; recall per tenant and quant
    at budget 1.0 against the exact NLJ; the kernel-build count flat from
    warmup to the end of serving; ``unload("laion")`` freeing its G_Y.
    Then the planner on the main engine and ``launch.serve_join --plan
    auto`` as a subprocess. Returns the tenants' launches (warmup and
    serving)."""
    from repro_torch.core import JoinConfig, exact_join_pairs
    from repro_torch.configs.vectorjoin import EngineSpec
    from repro_torch.data.vectors import table1_dataset, thresholds
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import JoinRequest, JoinService, ServiceConfig
    main_eng, sift = run["eng"], run["ds"]
    t0 = time.perf_counter()
    laion = table1_dataset("laion-like", n_data=OOD_N_DATA,
                           n_query=OOD_N_QUERY, seed=0)
    data = {"sift": (sift, run["theta"]),
            "laion": (laion, float(thresholds(laion, 7)[2]))}
    log(f"[serve] laion-like data {time.perf_counter() - t0:.1f}s; θ sift "
        f"{data['sift'][1]:.6f} laion {data['laion'][1]:.6f}")

    svc = JoinService(ServiceConfig(buckets=SERVE_BUCKETS), metrics=Metrics())
    svc.load("sift", main_eng.Y, engine_kw=dict(device=DEV),
             default=dataclasses.replace(JoinConfig(), method="es_sws",
                                         theta=run["theta"]))
    svc.engine("sift").adopt(index_y=main_eng.index_y())
    svc.load("laion", laion.Y, build_kw=EngineSpec().build_kw(),
             engine_kw=dict(device=DEV),
             default=dataclasses.replace(JoinConfig(), method="es_sws",
                                         theta=data["laion"][1]))
    engs = {n: svc.engine(n) for n in data}
    if engs["sift"].Y.data_ptr() != main_eng.Y.data_ptr():
        raise AssertionError("serve: the sift tenant copied the main Y")
    launches = {n: {} for n in data}
    warm_s = {}
    for name, (_, theta) in data.items():
        eng = engs[name]
        bs0 = eng.build_seconds
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        n_warm = svc.warmup(name, thetas=[theta], quants=("off", "sq8"))
        torch.cuda.synchronize()
        warm_s[name] = time.perf_counter() - t0
        add_launches(launches[name], ops.launch_counts())
        log(f"[serve/{name}] warmup: {n_warm} joins in {warm_s[name]:.2f}s "
            f"(builds {eng.build_seconds - bs0:.2f}s: {eng.build_counts}); "
            f"band cap estimates {eng._cap_estimates}; launches "
            f"{launched(launches[name])}")
    if engs["sift"].build_counts["index_y"] != 0:
        raise AssertionError("serve: the sift tenant built its own G_Y")
    if engs["laion"].build_counts["index_y"] != 1:
        raise AssertionError("serve: the laion warmup did not build G_Y")
    c_warm = obs_metrics.compile_count()

    serve_tenant = svc._serve_tenant

    def counted(tenant, items):
        ops.reset_launch_counts()
        out = serve_tenant(tenant, items)
        torch.cuda.synchronize()
        add_launches(launches[tenant], ops.launch_counts())
        return out
    svc._serve_tenant = counted
    reqs = serve_requests(data)
    for r, _ in reqs:
        if not svc.submit(r):
            raise AssertionError(f"serve: request {r.uid} was rejected: "
                                 f"{svc.failed.get(r.uid)}")
    bad = [JoinRequest(uid=SERVE_REQUESTS, tenant="sift", X=sift.X[:100],
                       theta=run["theta"], wave=100),
           JoinRequest(uid=SERVE_REQUESTS + 1, tenant="laion",
                       X=sift.X[:8], theta=data["laion"][1])]
    for r in bad:
        if svc.submit(r) is not False:
            raise AssertionError(f"serve: bad request {r.uid} admitted")
    t0 = time.perf_counter()
    done = svc.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    svc._serve_tenant = serve_tenant
    c_end = obs_metrics.compile_count()
    if c_end != c_warm:
        raise AssertionError(f"serve: {c_end - c_warm} kernel builds after "
                             f"warmup")
    if (svc.stats["rejected"] != len(bad)
            or any(done[r.uid].ok for r in bad)
            or not all(done[r.uid].ok for r, _ in reqs)):
        raise AssertionError(f"serve: rejections {dict(svc.stats)} "
                             f"{svc.failed}")
    n_q = sum(len(r.X) for r, _ in reqs)
    h = svc.metrics.get("serve_join.admission_seconds")
    occ = svc.metrics.get("serve_join.occupancy")
    log(f"[serve] {len(reqs)} requests ({n_q} queries) in {serve_s:.2f}s "
        f"({n_q / serve_s:.1f} queries/s); admission latency mean "
        f"{h.sum / h.count * 1e3:.2f} ms; occupancy mean "
        f"{occ.sum / occ.count:.4f}; rejected {svc.stats['rejected']} "
        f"({'; '.join(svc.failed.values())}); kernel builds: "
        f"{c_warm} at the end of warmup, {c_end} after serving (flat)")

    # the direct replay: the same plans, submitted in dispatch order
    plans = {r.uid: svc.plan(r) for r, _ in reqs}
    t0 = time.perf_counter()
    for name, eng in engs.items():
        eng.reset_stream()
        for r, _ in reqs:
            if r.tenant != name:
                continue
            off = eng.n_submitted
            direct = eng.submit(r.X, plans[r.uid])
            sj = done[r.uid]
            n_data = eng.Y.shape[0]
            if not (off == sj.qid_offset
                    and torch.equal(card_keys(torch, direct.pairs, n_data),
                                    card_keys(torch, sj.pairs, n_data))
                    and all(getattr(direct.stats, f) == getattr(sj.stats, f)
                            for f in SERVE_FIELDS)):
                raise AssertionError(f"serve/{name}: request {r.uid} differs "
                                     f"from its direct replay")
    torch.cuda.synchronize()
    log(f"[serve] direct replay in {time.perf_counter() - t0:.2f}s: every "
        f"request's pairs, qid_offset, {', '.join(SERVE_FIELDS)} equal")

    # soundness, and recall per tenant and quant at budget 1.0
    recs = {}
    for name, (ds, theta) in data.items():
        eng = engs[name]
        n_data = eng.Y.shape[0]
        Xt = torch.as_tensor(ds.X[:SERVE_SPAN], device=DEV)
        if name == "sift":
            truth = run["truth_keys"]
            truth = truth[truth < SERVE_SPAN * n_data]
        else:
            t0 = time.perf_counter()
            truth = card_keys(torch, exact_join_pairs(Xt, eng.Y, theta),
                              n_data)
            log(f"[serve/laion] card NLJ of the first {SERVE_SPAN} queries: "
                f"{truth.numel()} pairs ({time.perf_counter() - t0:.2f}s)")
        band = 0
        tally = {}
        for r, lo in reqs:
            if r.tenant != name:
                continue
            sj = done[r.uid]
            pairs = sj.pairs.copy()
            pairs[:, 0] += lo - sj.qid_offset       # the dataset's query ids
            band += check_sound(torch, Xt, eng.Y, pairs, theta)
            if r.recall_budget < 1.0:
                continue
            t = truth[(truth >= lo * n_data) & (truth < (lo + len(r.X))
                                                * n_data)]
            hit = int(torch.isin(card_keys(torch, pairs, n_data), t).sum())
            quant = plans[r.uid].quant
            hits, tot = tally.get(quant, (0, 0))
            tally[quant] = (hits + hit, tot + t.numel())
        for quant, (hit, tot) in sorted(tally.items()):
            recs[(name, quant)] = hit / max(tot, 1)
        log(f"[serve/{name}] sound (0 unsound; boundary band {band}); "
            f"recall at budget 1.0 " + " ".join(
                f"{q} {recs[(name, q)]:.6f} ({tally[q][1]} truth pairs)"
                for q in sorted(tally)))
    for key, floor in SERVE_RECALL_FLOORS.items():
        if recs[key] < floor:
            raise AssertionError(f"serve/{key}: recall {recs[key]} below "
                                 f"the floor {floor}")

    # unload the tenant that built its own G_Y: its memory comes back
    iy = engs["laion"]._index_y
    gy_bytes = sum(t.untyped_storage().nbytes()
                   for t in (iy.vecs, iy.nbrs, iy.start, iy.mean_nbr_dist)
                   if t.data_ptr() != engs["laion"].Y.data_ptr())
    del iy
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    if not svc.unload("laion"):
        raise AssertionError("serve: unload('laion') found no tenant")
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    log(f"[serve/laion] unload freed {freed / 2**20:.1f} MiB (its G_Y "
        f"beyond Y: {gy_bytes / 2**20:.1f} MiB); tenants {svc.tenants}")
    if freed < gy_bytes:
        raise AssertionError(f"serve: unload freed {freed} bytes, less than "
                             f"its G_Y's {gy_bytes}")
    for name in data:
        for k in SERVE_KERNELS:
            if launches[name].get(k, 0) == 0:
                raise AssertionError(f"serve/{name} path never launched {k}")
        log(f"[serve/{name}] launches (warmup and serving) "
            f"{launched(launches[name])}")

    # the planner on the main engine: it samples the 1M-row table
    t0 = time.perf_counter()
    cfg = main_eng.plan_config(sift.X[:2_000], main_eng.default)
    plan = main_eng.planner.plan(
        sift.X[:2_000], theta=run["theta"],
        pool_cap=int(main_eng.default.traversal.pool_cap),
        dim=int(main_eng.Y.shape[1]))
    log(f"[serve] plan_config on the main engine ({time.perf_counter() - t0:.2f}"
        f"s): method={cfg.method} quant={cfg.quant} wave={cfg.wave_size} "
        f"rerank_cap={plan.rerank_cap} merge_cap={plan.merge_cap} "
        f"predicted_pairs={plan.predicted_join_size:.0f} "
        f"predicted_seconds={plan.predicted_seconds} source={plan.source}")

    # the launcher, at its default sizes, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        trace, mjson = Path(tmp) / "trace.json", Path(tmp) / "metrics.json"
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_join", "--plan",
             "auto", "--trace", str(trace), "--metrics-json", str(mjson)],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(SRC)))
        for line in out.stdout.splitlines():
            log(f"[serve/cli] {line}")
        if out.returncode != 0:
            raise AssertionError(f"launch.serve_join exited "
                                 f"{out.returncode}:\n{out.stderr[-4000:]}")
        snap = json.loads(mjson.read_text())
        n_events = len(json.loads(trace.read_text())["traceEvents"])
        log(f"[serve/cli] exit 0 in {time.perf_counter() - t0:.1f}s; trace "
            f"{n_events} events; kernels.builds.serve_delta "
            f"{snap['counters']['kernels.builds.serve_delta']}")
    return {f"serve/{n}": launches[n] for n in data}


# ---------------------------------------------------------------------------
# phase 3e: the sharded join
# ---------------------------------------------------------------------------

# every sharded run puts SHARDS logical shards on the one card and joins
# the first SHARD_CUT queries
SHARDS = 4
SHARD_CUT = 2_000
# recall floors of the sharded joins: f32 measured on an H100 (PERF.md)
# minus 0.05; sq8 and pdx8 the PERF.md §2 floors of those modes
SHARD_RECALL_FLOORS = {"shard/f32": 0.948, "shard/sq8": 0.912,
                       "shard/pdx8": 0.920}
# the hybrid plan's data: SCALES["ci_hd"]'s shape in benchmarks/common.py
HYBRID_SHAPE = dict(n_data=4_000, n_query=128, dim=256)
HYBRID_SHARDS = 8
SHARD_STREAM_BATCH = 500
SHARD_SERVE_REQUESTS = 8
# the kernels each sharded path must launch: the per-shard f32 builds (#1,
# #2, #4) and probes (#3); the int8 probes (#7′) and the LSH merge-cap
# estimate (#8) under sq8; the PDX band re-rank (#11′) under pdx8; the
# vector-plan NLJ's #1
SHARD_KERNELS = {
    "shard/f32": ("pairwise_sq_dists", "rowwise_sq_dists",
                  "gather_sq_dists", "topk_merge", "pairwise_hamming"),
    "shard/sq8": ("gather_bounds_int8", "gather_sq_dists"),
    "shard/pdx8": ("gather_bounds_int8", "pdx_compact_gather"),
    "shard/nlj": ("pairwise_sq_dists",),
    "shard/stream": ("pairwise_sq_dists", "gather_sq_dists", "topk_merge"),
    "shard/serve": ("pairwise_sq_dists",),
}


def shard_step(torch, ops, name: str, fn, launches: dict):
    """Run one step of phase 3e with the launch counts reset just before
    and read just after (added to its path's ``launches``); logs its
    seconds and peak device memory. Returns ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    add_launches(launches.setdefault(name.split(":")[0], {}), counts)
    log(f"[{name}] {wall:.2f}s peak_mem_GB="
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"launches={launched(counts)}")
    return out


def differ_at_theta(torch, X, Y, a: np.ndarray, b: np.ndarray, theta: float,
                    n_data: int, what: str) -> int:
    """Pair sets ``a`` and ``b`` equal but for pairs within 16 f32 ulps of
    θ² in float64 (raises otherwise); returns how many such pairs
    differ."""
    ka, kb = card_keys(torch, a, n_data), card_keys(torch, b, n_data)
    diff = torch.cat([ka[~torch.isin(ka, kb)], kb[~torch.isin(kb, ka)]])
    if diff.numel():
        q, y = diff // n_data, diff % n_data
        d64 = ((X[q].double() - Y[y].double()) ** 2).sum(1)
        th2 = float(np.float32(theta)) ** 2
        if bool(((d64 - th2).abs() > ULP16 * th2).any()):
            raise AssertionError(f"{what}: {diff.numel()} pairs differ, not "
                                 f"all within 16 ulps of θ")
    return int(diff.numel())


def sharded_inputs(torch) -> dict:
    """Phase 3e's inputs without the main path (``--sharded-only``): the
    main path's data and θ, Y on the card, and the exact NLJ of the first
    SHARD_CUT queries."""
    from repro_torch.core import exact_join_pairs
    from repro_torch.data.vectors import table1_dataset, thresholds
    from repro_torch.engine import JoinEngine

    ds = table1_dataset("sift-like", n_data=MAIN_N_DATA,
                        n_query=MAIN_N_QUERY, seed=0)
    theta = float(thresholds(ds, 7)[1])
    eng = JoinEngine(ds.Y, device=DEV)
    truth = exact_join_pairs(ds.X[:SHARD_CUT], eng.Y, theta)
    return dict(ds=ds, theta=theta, eng=eng, launches={},
                truth_keys=card_keys(torch, truth, MAIN_N_DATA))


def run_sharded(torch, ops, run: dict) -> dict:
    """Phase 3e: the sharded join on SHARDS logical shards of the card
    (``DeviceMesh.on_device``), over the main engine's 1M x 128 card
    tensor (no copy) and its θ: es_mi_adapt in f32 on the first SHARD_CUT
    queries (per-shard builds; overlap on = off; sound; recall against the
    exact NLJ of those queries), under sq8 and pdx8, the ring label, the
    vector-plan mesh NLJ (= the exact NLJ, exactly), a hybrid plan on 8
    shards, sharded streaming (nlj and es_mi), a sharded serving tenant,
    ``vector_join``, and ``launch.join --shards``. Returns the launches
    per path."""
    from repro_torch.configs.vectorjoin import EngineSpec
    from repro_torch.core import (JoinConfig, exact_join_pairs, recall,
                                  vector_join)
    from repro_torch.core import distributed as D
    from repro_torch.core.types import JoinResult
    from repro_torch.data.vectors import make_dataset, thresholds
    from repro_torch.engine import JoinEngine
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import JoinRequest, JoinService, ServiceConfig

    t_phase = time.perf_counter()
    ds, theta, Y = run["ds"], run["theta"], run["eng"].Y
    n_data = int(Y.shape[0])
    Xs = ds.X[:SHARD_CUT]
    truth = run["truth_keys"]
    truth_s = truth[truth < SHARD_CUT * n_data]
    mesh = D.DeviceMesh.on_device(DEV, SHARDS)
    eng = JoinEngine(Y, build_kw=EngineSpec().build_kw(), n_shards=SHARDS,
                     mesh=mesh, metrics=Metrics(),
                     default=JoinConfig(theta=theta))
    launches: dict = {}

    def mi_join(tag: str, X, cfg, floor: float | None, n_q: int,
                off_run=None, overlap_off: bool = True):
        """The join with overlap on, then off (``off_run`` when given;
        none without ``overlap_off``)."""
        res = shard_step(torch, ops, f"{tag}:on",
                         lambda: eng.join(X, cfg), launches)
        off = shard_step(torch, ops, f"{tag}:off", off_run or (
            lambda: eng.join(X, dataclasses.replace(cfg, overlap=False))),
            launches) if overlap_off else None
        st = res.stats
        if off is not None and not torch.equal(
                card_keys(torch, res.pairs, n_data),
                card_keys(torch, off.pairs, n_data)):
            raise AssertionError(f"{tag}: overlap on/off pair sets differ")
        band = check_sound(torch, torch.as_tensor(X, device=DEV), Y,
                           res.pairs, theta)
        rec, rec_cap = recalls(torch, res.pairs,
                               truth[truth < n_q * n_data], n_data, n_q,
                               cfg.traversal.pool_cap)
        waves = -(-n_q // cfg.wave_size)
        log(f"[{tag}] pairs={len(res.pairs)} n_dist={st.n_dist} "
            f"n_iters={st.n_iters} (host syncs; {st.n_iters / waves:.1f} a "
            f"wave over {waves} waves) n_rerank={st.n_rerank} "
            f"overflow_retries={st.overflow_retries} "
            f"band_occ_per_shard={st.band_occ_per_shard} "
            f"bytes_allgather={st.bytes_allgather} "
            f"bytes_assembly={st.bytes_assembly} sound (boundary band "
            f"{band}) recall={rec:.6f} recall_within_pool_cap="
            f"{rec_cap:.6f}; " + (f"overlap off: same pairs, n_iters "
                                  f"{off.stats.n_iters}" if off is not None
                                  else "no overlap-off rerun"))
        if floor is not None and rec < floor:
            raise AssertionError(f"{tag}: recall {rec} below the floor "
                                 f"{floor}")
        return res, off

    # 1. es_mi_adapt in f32: the per-shard builds, overlap on and off;
    # 3. the run with overlap off is the driver's under the reference's
    # ring label (the port combines with all_gather either way, so the
    # pairs are the same and the pool's bytes move to bytes_ppermute)
    cfg = eng.default

    def ring_off():
        pairs, st = D.distributed_mi_join(
            torch.as_tensor(Xs, device=DEV), eng.sharded_index(Xs), mesh,
            "data", theta=theta, cfg=cfg.traversal,
            wave_size=cfg.wave_size, hybrid=True, n_data=n_data,
            overlap=False, plan=D.MeshPlan(n_shards=SHARDS,
                                           pool_combine="ppermute"))
        return JoinResult(pairs[pairs[:, 1] < n_data], st)
    f32, ring = mi_join("shard/f32", Xs, cfg,
                        SHARD_RECALL_FLOORS["shard/f32"], SHARD_CUT,
                        off_run=ring_off)
    if ring.stats.bytes_allgather or not ring.stats.bytes_ppermute:
        raise AssertionError("shard: the ring label's bytes are not "
                             "metered as ppermute")
    log(f"[shard/ring] overlap off under the ppermute label = all_gather "
        f"with overlap on: {len(ring.pairs)} pairs; bytes_ppermute="
        f"{ring.stats.bytes_ppermute} (all_gather's bytes_allgather "
        f"{f32.stats.bytes_allgather})")
    smi = eng.sharded_index(Xs)
    log(f"[shard/f32] {SHARDS} per-shard builds of "
        f"{smi.shards[0].n_nodes} nodes: {eng.build_seconds:.2f}s "
        f"(build_counts {eng.build_counts}); kNN blocks "
        f"{launches['shard/f32']['topk_merge']} against the single build's "
        f"{run['launches'].get('topk_merge')}")
    if run.get("pairs") is not None:
        un = run["pairs"][run["pairs"][:, 0] < SHARD_CUT]
        un_rec, _ = recalls(torch, un, truth_s, n_data, SHARD_CUT,
                            cfg.traversal.pool_cap)
        log(f"[shard/f32] the unsharded join on the same queries (phase "
            f"3's pairs): recall={un_rec:.6f} pairs={len(un)}")

    # 2. sq8 and pdx8: per-shard stores, #7′ and #11′ (no overlap-off
    # reruns, 18-23 s each: the smoke's time limit; f32's above holds
    # the sharded overlap on = off)
    for quant in ("sq8", "pdx8"):
        mi_join(f"shard/{quant}", Xs, dataclasses.replace(cfg, quant=quant),
                SHARD_RECALL_FLOORS[f"shard/{quant}"], SHARD_CUT,
                overlap_off=False)

    # 4. the vector-plan mesh NLJ: the exact NLJ's pairs, exactly (#1)
    nlj = shard_step(torch, ops, "shard/nlj", lambda: eng.join(
        Xs, dataclasses.replace(cfg, method="nlj")), launches)
    if not torch.equal(card_keys(torch, nlj.pairs, n_data), truth_s):
        raise AssertionError("shard/nlj: the mesh NLJ's pairs differ from "
                             "the single-device exact NLJ's")
    log(f"[shard/nlj] {len(nlj.pairs)} pairs = the exact NLJ of the first "
        f"{SHARD_CUT} queries; plan {eng._mesh_plan(traversal=False)}; "
        f"bytes_allgather={nlj.stats.bytes_allgather} "
        f"overflow_retries={nlj.stats.overflow_retries}")

    # 5. a hybrid plan: 8 shards → 2 data × 4 model
    hd = make_dataset("manifold", seed=0, **HYBRID_SHAPE)
    th_hd = float(thresholds(hd, 7)[1])
    heng = JoinEngine(hd.Y, n_shards=HYBRID_SHARDS, metrics=Metrics(),
                      mesh=D.DeviceMesh.on_device(DEV, HYBRID_SHARDS))
    hres = shard_step(torch, ops, "shard/hybrid", lambda: heng.join(
        hd.X, JoinConfig(method="nlj", theta=th_hd)), launches)
    hplan = heng._mesh_plan(traversal=False)
    if (hplan.n_shards, hplan.dim_shards) != (2, 4):
        raise AssertionError(f"shard/hybrid: planned {hplan}")
    hX = torch.as_tensor(hd.X, device=DEV)
    hY = torch.as_tensor(hd.Y, device=DEV)
    h_truth = exact_join_pairs(hX, hY, th_hd)
    n_band = differ_at_theta(torch, hX, hY, hres.pairs, h_truth, th_hd,
                             HYBRID_SHAPE["n_data"], "shard/hybrid")
    if hres.stats.bytes_psum <= 0:
        raise AssertionError("shard/hybrid: no psum traffic metered")
    log(f"[shard/hybrid] {hplan}: {len(hres.pairs)} pairs = the exact NLJ's "
        f"({len(h_truth)}) but for {n_band} within 16 ulps of θ; "
        f"bytes_psum={hres.stats.bytes_psum}")

    # 6. streaming: nlj in 4 batches, es_mi in 2, under global ids
    batches = [Xs[b:b + SHARD_STREAM_BATCH]
               for b in range(0, SHARD_CUT, SHARD_STREAM_BATCH)]
    streamed = shard_step(torch, ops, "shard/stream:nlj", lambda: [
        eng.submit(b, cfg, method="nlj") for b in batches], launches)
    sp = np.concatenate([r.pairs for r in streamed])
    if not torch.equal(card_keys(torch, sp, n_data), truth_s):
        raise AssertionError("shard/stream: the streamed nlj batches differ "
                             "from the exact NLJ")
    mi_b = batches[:2]
    streamed = shard_step(torch, ops, "shard/stream:es_mi", lambda: [
        eng.submit(b, cfg, method="es_mi") for b in mi_b], launches)
    for i, (b, r) in enumerate(zip(mi_b, streamed)):
        j = eng.join(b, cfg, method="es_mi")
        shifted = j.pairs + np.array([i * SHARD_STREAM_BATCH + SHARD_CUT, 0])
        if not torch.equal(card_keys(torch, r.pairs, n_data),
                           card_keys(torch, shifted, n_data)):
            raise AssertionError(f"shard/stream: es_mi batch {i} differs "
                                 f"from its join shifted by its offset")
    if eng.n_submitted != SHARD_CUT + 2 * SHARD_STREAM_BATCH:
        raise AssertionError(f"shard/stream: n_submitted {eng.n_submitted}")
    log(f"[shard/stream] nlj x{len(batches)} = the exact NLJ; es_mi x2 = "
        f"join shifted by the offset; n_submitted={eng.n_submitted}")

    # 7. serving: a 4-shard sift tenant answers nlj requests
    svc = JoinService(ServiceConfig(buckets=(64, 128, 256)),
                      metrics=Metrics())
    rng = np.random.default_rng(SERVE_SEED)
    reqs = []
    for uid in range(SHARD_SERVE_REQUESTS):
        n = int(rng.integers(1, 257))
        lo = int(rng.integers(0, SHARD_CUT - n + 1))
        reqs.append(JoinRequest(uid=uid, tenant="sift", X=ds.X[lo:lo + n],
                                theta=theta, method="nlj", quant="off"))

    def serve():
        svc.load("sift", Y, engine_kw=dict(n_shards=SHARDS, mesh=mesh))
        for r in reqs:
            if not svc.submit(r):
                raise AssertionError(f"shard/serve: uid {r.uid} rejected")
        bad = JoinRequest(uid=99, tenant="sift", X=ds.X[:8], theta=theta,
                          method="es_sws", quant="off")
        if svc.submit(bad) or svc.stats["rejected"] != 1:
            raise AssertionError("shard/serve: es_sws on a sharded tenant "
                                 "was not rejected")
        return svc.run()
    done = shard_step(torch, ops, "shard/serve", serve, launches)
    teng = svc.engine("sift")
    teng.reset_stream()
    for r in reqs:
        direct = teng.submit(r.X, svc.plan(r))
        sj = done[r.uid]
        if not (sj.ok and torch.equal(card_keys(torch, direct.pairs, n_data),
                                      card_keys(torch, sj.pairs, n_data))):
            raise AssertionError(f"shard/serve: uid {r.uid} differs from "
                                 f"its direct replay")
    log(f"[shard/serve] {len(reqs)} nlj requests = their direct replays; "
        f"rejected {svc.stats['rejected']} ({svc.failed.get(99)})")
    svc.unload("sift")

    # 8. vector_join with index_merged = the engine's join
    e1 = JoinEngine(hd.Y, device=DEV, metrics=Metrics())
    want = e1.join(hd.X, JoinConfig(theta=th_hd))
    got = shard_step(torch, ops, "one_shot", lambda: vector_join(
        hd.X, hd.Y, JoinConfig(theta=th_hd),
        index_merged=e1.merged_index(hd.X), device=DEV), launches)
    hkeys = card_keys(torch, want.pairs, HYBRID_SHAPE["n_data"])
    if not (isinstance(got, JoinResult) and torch.equal(
            card_keys(torch, got.pairs, HYBRID_SHAPE["n_data"]), hkeys)
            and got.stats.n_dist == want.stats.n_dist):
        raise AssertionError("vector_join differs from the engine's join")
    log(f"[one_shot] vector_join = eng.join: {len(got.pairs)} pairs, "
        f"n_dist={got.stats.n_dist}, recall "
        f"{recall(got, h_truth):.6f}")

    # 9. the launcher with --shards, in a process of its own
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.join", "--shards",
         str(SHARDS), "--device", ",".join(["cuda:0"] * SHARDS),
         "--n-data", "200000", "--n-query", "512", "--dim", "64",
         "--engine-spec", "ci"], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(SRC)))
    for line in out.stdout.splitlines():
        log(f"[shard/cli] {line}")
    if out.returncode != 0 or "sound=True" not in out.stdout:
        raise AssertionError(f"launch.join --shards exited {out.returncode}:"
                             f"\n{out.stderr[-4000:]}")
    log(f"[shard/cli] exit 0 in {time.perf_counter() - t0:.1f}s")
    del eng, heng, e1
    log(f"[shard] phase 3e {time.perf_counter() - t_phase:.1f}s")
    for name, kernels in SHARD_KERNELS.items():
        missing = [k for k in kernels if launches[name].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{name} path never launched {missing}")
    return launches


# ---------------------------------------------------------------------------
# phase 5d: the LM serving path (gemma2-9b at full width), in a process of
# its own (``--lm-only``)
# ---------------------------------------------------------------------------

LM_ARCH = "gemma2_9b"
LM_SLOTS, LM_S_MAX = 4, 4_608
LM_REQUESTS, LM_PROMPTS, LM_MAX_NEW = 8, (16, 512), 32
# one prompt past the local layers' 4,096-token window: their rings wrap
LM_LONG = 4_200
# |prefill or decode logits − forward logits| allowed in bf16 at 42
# layers: five times the largest reading of the first H100 run (0.0103,
# decode on the long prompt; PERF.md); the reference allows 2e-2 / 3e-2
# at 4 layers
LM_TOL = 0.05
# the smoke configs in f32: decode = forward within LM_SMOKE_TOL; a
# batched request's greedy token may differ from its solo run's only where
# the top two logits lie within LM_TIE (counted)
LM_SMOKE_TOL = 1e-4
LM_TIE = 1e-4
LM_SMOKE_LENGTHS = (3, 24, 9, 17, 5)
LM_SMOKE_MAX_NEW = 12
# the temperature of phase 5d's one sampled run
LM_TEMPERATURE = 0.8


def lm_positions(torch, mc, n: int, start: int = 0):
    p = torch.arange(start, start + n, dtype=torch.int32, device=DEV)[None]
    return torch.stack([p] * mc.pos_dims, -1) if mc.pos_dims > 1 else p


def lm_prompt(mc, rng, n: int) -> np.ndarray:
    if mc.input_kind == "embeddings":
        return rng.normal(size=(n, mc.frontend_dim)).astype(np.float32)
    return rng.integers(0, mc.vocab, n).astype(np.int32)


def lm_forward_logits(torch, M, model, mc, parts, n_last: int):
    """The full forward's f32 logits at the last ``n_last`` positions of
    the sequence ``parts`` (token ids or frames, (1, n, ...) tensors)
    embedded and concatenated: qwen2-vl's frames then its text tokens."""
    h = torch.cat([M._embed_inputs(model, p) for p in parts], 1)
    pos = lm_positions(torch, mc, h.shape[1])
    with torch.inference_mode():
        for blk in model.layers:
            h = blk(h, pos, exact_moe=True)
    h = M.rms_norm(h[:, -n_last:], model.final_norm)
    return M.logits_fn(model, h)[0]


def lm_decode_vs_forward(torch, M, model, mc, prompt, tok, s_max: int
                         ) -> tuple[float, float, float]:
    """Prefill ``prompt`` (1, S, ...), decode ``tok`` (1, 1): max |logit −
    forward logit| at the last prompt position and at the next one, and
    the prefill's seconds (synchronized). Every logit must be finite."""
    S = prompt.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, caches = M.prefill(model, prompt, lm_positions(torch, mc, S), s_max)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    lg2, _ = M.decode_step(model, tok, lm_positions(torch, mc, 1, S),
                           caches, torch.tensor([S], device=DEV))
    want = lm_forward_logits(torch, M, model, mc, (prompt, tok), 2)
    for got in (lg, lg2, want):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{mc.name}: non-finite logits")
    return (float((lg[0] - want[0]).abs().max()),
            float((lg2[0] - want[1]).abs().max()), sec)


def lm_flips(torch, M, model, mc, req, got: list, alone: list) -> int:
    """Where a request's batched tokens leave its solo run's: 0 if they
    agree, 1 if they first part where the solo run's top two logits lie
    within LM_TIE (a near-tie the batch shape may round either way);
    otherwise the run is wrong."""
    j = next((i for i, (a, b) in enumerate(zip(got, alone)) if a != b), None)
    if j is None and len(got) == len(alone):
        return 0
    if j is None:
        raise AssertionError(f"{mc.name} uid {req.uid}: {len(got)} tokens "
                             f"against {len(alone)} alone")
    prompt = torch.from_numpy(np.asarray(req.prompt)).to(DEV)[None]
    toks = torch.tensor([alone[:j]], dtype=torch.int32, device=DEV)
    top2 = torch.topk(lm_forward_logits(torch, M, model, mc,
                                        (prompt, toks), 1)[0], 2).values
    gap = float(top2[0] - top2[1])
    if gap > LM_TIE:
        raise AssertionError(
            f"{mc.name} uid {req.uid}: batched token {j} = {got[j]}, alone "
            f"{alone[j]}, top-two gap {gap:.3g} > {LM_TIE}")
    return 1


def lm_quartiles(steps, field: int) -> str:
    """'median (q1-q3)' of one field of ``lm_serve_timed``'s steps."""
    q1, q2, q3 = statistics.quantiles([st[field] for st in steps], n=4)
    return f"{q2:.3f} ({q1:.3f}-{q3:.3f})"


def lm_serve_timed(torch, mc, eng, reqs):
    """``eng.run(reqs)`` timed (synchronized), each decode step timed with
    its active lanes, the K/V bytes of their valid positions (a global
    layer's first length + 1 rows, a ring layer's at most its window) and
    the ms of its token choice (``_pick``, timed from a synchronize after
    the step's logits). Every request must come back whole."""
    steps, picks = [], []
    step, pick = eng.step, eng._pick

    def timed_pick(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pick(*a)
        picks.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_step():
        lanes = [i for i, sl in enumerate(eng.slots) if sl.active]
        kv = sum(min(int(eng.lengths[i]) + 1, c["k"].shape[1])
                 * (c["k"][0, 0].nbytes + c["v"][0, 0].nbytes)
                 for c in eng.caches for i in lanes)
        picks.clear()
        t = time.perf_counter()
        step()
        steps.append((len(lanes), (time.perf_counter() - t) * 1e3, kv,
                      sum(picks)))
    eng.step, eng._pick = timed_step, timed_pick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    # the wrappers close over eng: unset them, so that dropping the engine
    # frees its caches at once, not at the next garbage collection
    del eng.step, eng._pick
    if sorted(done) != [r.uid for r in reqs] or eng.failed or any(
            len(done[r.uid]) != r.max_new for r in reqs):
        raise AssertionError(f"{mc.name}: served {sorted(done)}, failed "
                             f"{eng.failed}")
    return eng, done, serve_s, steps


def lm_smoke_archs(torch) -> None:
    """Every decodable smoke config in f32 on the card: prefill and decode
    = the forward within LM_SMOKE_TOL, and a 2-slot engine gives each
    request its solo run's greedy tokens (near-tie flips counted);
    hubert's engine raises ValueError."""
    from repro_torch.configs import ARCH_IDS, get
    from repro_torch.models import model as M
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(31)
    for arch in ARCH_IDS:
        mc = get(arch).smoke.with_overrides(dtype=torch.float32)
        model = M.init_params(mc, device=DEV, generator=torch.Generator(
            device=DEV).manual_seed(2))
        if mc.encoder_only:
            try:
                ServeEngine(mc, model, n_slots=2, s_max=32, device=DEV)
            except ValueError:
                log(f"[lm/smoke] {arch}: encoder-only, ServeEngine raised "
                    f"ValueError")
                continue
            raise AssertionError(f"{arch}: ServeEngine did not refuse an "
                                 f"encoder-only model")
        prompt = torch.from_numpy(lm_prompt(mc, rng, 20)).to(DEV)[None]
        tok = torch.from_numpy(rng.integers(0, mc.vocab, (1, 1)).astype(
            np.int32)).to(DEV)
        e_pre, e_dec, _ = lm_decode_vs_forward(torch, M, model, mc, prompt,
                                               tok, 32)
        if max(e_pre, e_dec) > LM_SMOKE_TOL:
            raise AssertionError(f"{arch}: prefill/decode vs forward "
                                 f"{e_pre:.3g} / {e_dec:.3g} > "
                                 f"{LM_SMOKE_TOL}")
        reqs = [Request(uid=i, prompt=lm_prompt(mc, rng, n),
                        max_new=LM_SMOKE_MAX_NEW)
                for i, n in enumerate(LM_SMOKE_LENGTHS)]
        eng = ServeEngine(mc, model, n_slots=2, s_max=48, metrics=Metrics(),
                          device=DEV)
        done = eng.run(reqs)
        if sorted(done) != list(range(len(reqs))) or eng.failed:
            raise AssertionError(f"{arch}: served {sorted(done)}, failed "
                                 f"{eng.failed}")
        flips = sum(lm_flips(torch, M, model, mc, r, done[r.uid], ServeEngine(
            mc, model, n_slots=2, s_max=48, metrics=Metrics(),
            device=DEV).run([r])[r.uid]) for r in reqs)
        log(f"[lm/smoke] {arch}: prefill/decode vs forward {e_pre:.3g} / "
            f"{e_dec:.3g}; {len(reqs)} requests batched = alone, near-tie "
            f"flips {flips}; occupancy "
            f"{eng.stats['occupancy_sum'] / eng.stats['decode_steps']:.4f}")


def run_lm(torch, smi: str) -> None:
    """gemma2-9b at its published width and depth, bf16, random weights
    from a seeded generator on the card, served by ``ServeEngine``; then
    the smoke configs in f32, then ``launch.serve`` in a process of its
    own."""
    from repro_torch.configs import get
    from repro_torch.models import model as M
    from repro_torch.obs.metrics import Metrics
    from repro_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mc = get(LM_ARCH).model
    n_params = M.param_count(mc)
    t0 = time.perf_counter()
    model = M.init_params(mc, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[lm] {mc.name}: {mc.n_layers} layers, d {mc.d_model}, "
        f"{n_params} parameters, {w_bytes / 1e9:.3f} GB of weights, drawn "
        f"in {time.perf_counter() - t0:.2f}s ({smi})")

    rng = np.random.default_rng(23)
    prompts = [lm_prompt(mc, rng, int(rng.integers(LM_PROMPTS[0],
                                                   LM_PROMPTS[1] + 1)))
               for _ in range(LM_REQUESTS)]
    prompts.append(lm_prompt(mc, rng, LM_LONG))
    # decode vs forward: the long prompt (through the ring) and a short one
    errs = {}
    for name, pr in (("long", prompts[-1]), ("short", prompts[0])):
        x = torch.from_numpy(pr).to(DEV)[None]
        tok = torch.from_numpy(rng.integers(0, mc.vocab, (1, 1)).astype(
            np.int32)).to(DEV)
        lm_decode_vs_forward(torch, M, model, mc, x, tok, LM_S_MAX)  # warm
        e_pre, e_dec, sec = errs[name] = lm_decode_vs_forward(
            torch, M, model, mc, x, tok, LM_S_MAX)
        log(f"[lm] {name} prompt ({len(pr)} tokens): |prefill - forward| "
            f"{e_pre:.6f}, |decode - forward| {e_dec:.6f} (tolerance "
            f"{LM_TOL}); prefill {sec * 1e3:.3f} ms ({smi})")
        if max(e_pre, e_dec) > LM_TOL:
            raise AssertionError(f"{mc.name}: {name} prompt's logits differ "
                                 f"from the forward's by {max(e_pre, e_dec)}")

    reqs = [Request(uid=i, prompt=p, max_new=LM_MAX_NEW)
            for i, p in enumerate(prompts)]
    eng, done, serve_s, steps = lm_serve_timed(
        torch, mc, ServeEngine(mc, model, n_slots=LM_SLOTS, s_max=LM_S_MAX,
                               metrics=Metrics(), device=DEV), reqs)
    full = [st for st in steps if st[0] == LM_SLOTS]
    step_ms = statistics.median(st[1] for st in full)
    # the HBM bound of a step: the weights, plus the K/V rows of each
    # active lane's valid positions (what the step needs), or of every
    # slot of every cache (what decode_attend reads now)
    bound = statistics.median((w_bytes + st[2]) / PEAK_BYTES * 1e3
                              for st in full)
    kv_whole = sum(c[k].numel() * c[k].element_size()
                   for c in eng.caches for k in ("k", "v"))
    bound_whole = (w_bytes + kv_whole) / PEAK_BYTES * 1e3
    occ = eng.stats["occupancy_sum"] / eng.stats["decode_steps"]
    tok_s = eng.stats["generated"] / serve_s
    log(f"[lm] served {len(done)} requests ({eng.stats['generated']} tokens, "
        f"prompts {min(map(len, prompts))}-{max(map(len, prompts))}) in "
        f"{serve_s:.3f}s = {tok_s:.1f} tokens/s; "
        f"{eng.stats['decode_steps']} decode steps, occupancy {occ:.4f}; "
        f"decode step at {LM_SLOTS} lanes {lm_quartiles(full, 1)} ms over "
        f"{len(full)} steps against its HBM bound {bound:.3f} ms (median of "
        f"the steps': weights {w_bytes / 1e9:.3f} GB + the valid K/V, "
        f"{statistics.median(st[2] for st in full) / 1e9:.3f} GB at the "
        f"median, at {PEAK_BYTES / 1e12:.2f} TB/s); with the whole cache "
        f"that decode_attend reads ({kv_whole / 1e9:.3f} GB) "
        f"{bound_whole:.3f} ms; token choice {lm_quartiles(full, 3)} ms a "
        f"step ({smi})")
    del eng
    # one sampled run over the first LM_SLOTS requests, one full wave
    # (temperature LM_TEMPERATURE: Gumbel noise drawn on the card, one
    # argmax over the lanes)
    eng, sampled, _, steps2 = lm_serve_timed(
        torch, mc, ServeEngine(mc, model, n_slots=LM_SLOTS, s_max=LM_S_MAX,
                               temperature=LM_TEMPERATURE, seed=5,
                               metrics=Metrics(), device=DEV),
        reqs[:LM_SLOTS])
    full2 = [st for st in steps2 if st[0] == LM_SLOTS]
    step_ms2 = statistics.median(st[1] for st in full2)
    if not all(0 <= t < mc.vocab for t in sum(sampled.values(), [])):
        raise AssertionError(f"{mc.name}: a sampled token outside the vocab")
    as_greedy = sum(a == b for u, out in sampled.items()
                    for a, b in zip(out, done[u]))
    log(f"[lm] sampled (temperature {LM_TEMPERATURE}), the first "
        f"{LM_SLOTS} requests: decode step at {LM_SLOTS} lanes "
        f"{lm_quartiles(full2, 1)} ms over {len(full2)} steps, token choice "
        f"{lm_quartiles(full2, 3)} ms a step; share of tokens equal to "
        f"greedy {as_greedy / (LM_SLOTS * LM_MAX_NEW):.4f} ({smi})")
    del eng
    # the same wave greedy again, right after: the like-for-like greedy
    # step beside the sampled one
    eng, again, _, steps3 = lm_serve_timed(
        torch, mc, ServeEngine(mc, model, n_slots=LM_SLOTS, s_max=LM_S_MAX,
                               metrics=Metrics(), device=DEV),
        reqs[:LM_SLOTS])
    full3 = [st for st in steps3 if st[0] == LM_SLOTS]
    step_ms3 = statistics.median(st[1] for st in full3)
    as_before = sum(a == b for u, out in again.items()
                    for a, b in zip(out, done[u]))
    log(f"[lm] greedy again, the first {LM_SLOTS} requests: decode step at "
        f"{LM_SLOTS} lanes {lm_quartiles(full3, 1)} ms over {len(full3)} "
        f"steps, token choice {lm_quartiles(full3, 3)} ms a step; share of "
        f"tokens equal to the first greedy run "
        f"{as_before / (LM_SLOTS * LM_MAX_NEW):.4f} ({smi})")
    del eng
    same = []
    for r in reqs[:LM_SLOTS]:             # the smoke's time limit
        alone = ServeEngine(mc, model, n_slots=LM_SLOTS, s_max=LM_S_MAX,
                            metrics=Metrics(), device=DEV).run([r])[r.uid]
        same.append(sum(a == b for a, b in zip(done[r.uid], alone))
                    / LM_MAX_NEW)
    log(f"[lm] share of the first {LM_SLOTS} requests' greedy tokens equal "
        f"to their solo runs: {[round(x, 4) for x in same]}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm] peak device memory {peak:.3f} GB; gemma2-9b part "
        f"{time.perf_counter() - t_phase:.1f}s ({smi})")
    print("[lm] " + json.dumps(dict(
        arch=LM_ARCH, params=n_params, weight_gb=w_bytes / 1e9,
        peak_gb=peak, prefill_ms_long=errs["long"][2] * 1e3,
        decode_ms_median=step_ms, decode_bound_ms=bound,
        decode_bound_whole_cache_ms=bound_whole, tokens_per_s=tok_s,
        decode_steps=len(steps), decode_ms_median_sampled=step_ms2,
        decode_ms_median_greedy_again=step_ms3,
        pick_ms_median=statistics.median(st[3] for st in full),
        pick_ms_median_sampled=statistics.median(st[3] for st in full2),
        token_share_alone=same)), flush=True)
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    lm_smoke_archs(torch)
    log(f"[lm/smoke] nine smoke configs in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         LM_ARCH], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    for line in out.stdout.splitlines():
        log(f"[lm/cli] {line}")
    if out.returncode != 0 or not out.stdout.startswith("[serve] "):
        raise AssertionError(f"launch.serve exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    log(f"[lm/cli] exit 0 in {time.perf_counter() - t0:.1f}s")
    log(f"[lm] phase 5d {time.perf_counter() - t_phase:.1f}s")


def run_lm_process() -> None:
    """Phase 5d in a process of its own, so the join phases' memory and
    profiler do not touch it; its failure fails the smoke."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--lm-only"], timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"the LM phase exited {out.returncode}")
    log(f"[lm] process done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 5e: the LM training path (tinyllama-1.1b at full width), in a
# process of its own (``--train-only``)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "tinyllama_1_1b"
# 8 sequences of the model's published 2,048-token context a step, in two
# micro-batches of 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 2_048, 2, 8
# peak lr: on an H100 (PERF.md) 1e-3 diverged after the 2-step
# warmup (10.76 → 12.99) and 2e-4 spiked (8.73 → 12.30) before falling
TRAIN_LR, TRAIN_WARMUP = 5e-5, 2
# H100 SXM dense bf16 peak on the tensor cores (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
# the smoke configs in f32: one step's loss, aux and grad norm on the card
# = the CPU's within TRAIN_SMOKE_RTOL (relative; sums in another order)
TRAIN_SMOKE_RTOL = 1e-4
# |dot_f32's grads on the card − the CPU route's|, relative to the largest
# grad: both round an f32 sum to bf16, so within a bf16 ulp (2^-8)
DOT_BWD_RTOL = 2.0**-8


def train_bound_ms(mc, M, tokens: int, seqs: int, seq: int
                   ) -> tuple[float, float]:
    """The least time of one training step on one H100: 6 × (parameters
    that enter a product: all but the token table of an untied model) ×
    tokens at the bf16 peak, plus the attention products a causal model
    needs at the f32 peak (they run in f32, TF32 off): QKᵀ and PV, 2
    flops a multiply-add over the S²/2 causal pairs, H heads of hd, and
    the backward's four products twice the forward's two, so 3 · 2 · 2 ·
    S²/2 · H · hd = 6 · S² · H · hd a layer and sequence. Returns (bound
    ms, its bf16 part ms)."""
    n = M.param_count(mc) - (0 if mc.tie_embeddings else mc.vocab * mc.d_model)
    mm_ms = 6 * n * tokens / PEAK_BF16_FLOPS * 1e3
    attn = sum(6 * seq * seq * bc.attn.n_heads * bc.attn.head_dim
               for bc in mc.period if bc.mixer == "attn") * mc.n_groups * seqs
    return mm_ms + attn / PEAK_F32_FLOPS * 1e3, mm_ms


def train_smoke_archs(torch) -> None:
    """Every arch's smoke config in f32 takes one training step (AdamW,
    f32 moments) from the same weights and batch on the card and on the
    CPU: loss, aux and grad norm within TRAIN_SMOKE_RTOL."""
    from repro_torch.configs import ARCH_IDS, get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    rng = np.random.default_rng(41)
    for arch in ARCH_IDS:
        mc = get(arch).smoke.with_overrides(dtype=torch.float32)
        data = SyntheticLM(vocab=mc.vocab, seq_len=16, global_batch=4,
                           seed=7, pos_dims=mc.pos_dims).batch_at(0)
        if mc.input_kind == "embeddings":
            # frames drawn here: SyntheticLM's frontend frames raise, in the
            # reference as in the port (ROADMAP Queue C)
            data["inputs"] = rng.normal(size=(4, 16, mc.frontend_dim)
                                        ).astype(np.float32)
        cpu = M.init_params(mc, device="cpu", generator=torch.Generator(
            ).manual_seed(3))
        out = {}
        for dev in ("cpu", DEV):
            model = M.params_from_numpy(mc, M.params_to_numpy(mc, cpu), dev)
            opt = adamw()
            params = dict(model.named_parameters())
            step = make_train_step(mc, opt, lambda s: 1e-3, microbatches=2)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
            _, _, m = step(model, opt.init(params), batch, 0)
            out[dev] = {k: float(m[k]) for k in ("loss", "aux", "grad_norm")}
        errs = {k: abs(out[DEV][k] - out["cpu"][k])
                / max(abs(out["cpu"][k]), 1e-12) for k in out["cpu"]}
        log(f"[train/smoke] {arch}: card {out[DEV]} cpu {out['cpu']}; "
            f"relative errors {max(errs.values()):.3g}")
        if not all(np.isfinite(v) for v in out[DEV].values()) or max(
                errs.values()) > TRAIN_SMOKE_RTOL:
            raise AssertionError(f"{arch}: the card's step {out[DEV]} is not "
                                 f"the CPU's {out['cpu']}")


def check_dot_f32_backward(torch) -> None:
    """``dot_f32``'s card route (bf16 operands, ``torch.mm`` with an f32
    output, which has no derivative of its own: ``layers._MmF32``) under
    autograd: its grads = the CPU route's (the operands upcast, the f32
    cotangents rounded to bf16, as the reference's ``dot_general``
    transposes give them) within DOT_BWD_RTOL."""
    from repro_torch.models.layers import dot_f32
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(2, 64, 256, generator=gen).bfloat16()
    w = (torch.randn(256, 1000, generator=gen) / 16).bfloat16()
    r = torch.randn(2, 64, 1000, generator=gen)
    grads = {}
    for dev in ("cpu", DEV):
        xd = x.to(dev, copy=True).requires_grad_(True)
        wd = w.to(dev, copy=True).requires_grad_(True)
        out = dot_f32(xd, wd)
        if out.dtype != torch.float32:
            raise AssertionError(f"dot_f32 returned {out.dtype} on {dev}")
        (out * r.to(dev)).sum().backward()
        grads[dev] = (xd.grad.float().cpu(), wd.grad.float().cpu())
    for name, a, b in zip(("x", "w"), grads["cpu"], grads[DEV]):
        err = float((a - b).abs().max() / a.abs().max())
        log(f"[train/dot_f32] grad of {name} on the card vs the CPU route: "
            f"{err:.3g} of the largest (tolerance {DOT_BWD_RTOL:.3g})")
        if err > DOT_BWD_RTOL:
            raise AssertionError(f"dot_f32's backward on the card: {name} "
                                 f"off by {err}")


def run_train(torch, smi: str) -> None:
    """tinyllama-1.1b at its published width and depth, bf16, random
    weights from a seeded generator on the card, trained TRAIN_STEPS steps
    of TRAIN_BATCH × TRAIN_SEQ tokens through ``Trainer`` (AdamW with bf16
    moments, warmup-cosine, ``SyntheticLM``); then one step of every smoke
    config in f32 on the card against the CPU, ``dot_f32``'s backward, and
    ``launch.train`` in a process of its own, run twice: the second
    resumes from the first one's checkpoint."""
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import Trainer, TrainState, make_train_step

    t_phase = time.perf_counter()
    check_dot_f32_backward(torch)
    torch.cuda.reset_peak_memory_stats()
    mc = get(TRAIN_ARCH).model
    model = M.init_params(mc, device=DEV, generator=torch.Generator(
        device=DEV).manual_seed(0))
    n_params = M.param_count(mc)
    opt = adamw(moment_dtype=torch.bfloat16)
    lr = warmup_cosine(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    step_fn = make_train_step(mc, opt, lr, microbatches=TRAIN_MICRO)
    src = SyntheticLM(vocab=mc.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    state = TrainState(params=model,
                       opt_state=opt.init(dict(model.named_parameters())))
    lines = []
    trainer = Trainer(step_fn=step_fn, source=src, log_every=1,
                      log=lines.append, device=DEV)
    state, hist = trainer.run(state, TRAIN_STEPS)
    torch.cuda.synchronize()
    for ln in lines:
        log(f"[train] {ln}")
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{mc.name}: losses {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = statistics.median(h["seconds"] for h in hist[1:]) * 1e3
    bound, mm_ms = train_bound_ms(mc, M, tokens, TRAIN_BATCH, TRAIN_SEQ)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {mc.name}: {mc.n_layers} layers, d {mc.d_model}, "
        f"{n_params} parameters; {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} micro-batches, remat "
        f"{mc.remat}; losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}; first step "
        f"{hist[0]['seconds'] * 1e3:.1f} ms, median of the rest "
        f"{step_ms:.1f} ms = {tokens / step_ms * 1e3:.1f} tokens/s against a "
        f"bound of {bound:.1f} ms ({mm_ms:.1f} ms of bf16 products at "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {bound - mm_ms:.1f} ms of f32 "
        f"attention products at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s; share "
        f"{bound / step_ms:.4f}); peak device memory {peak:.3f} GB ({smi})")
    print("[train] " + json.dumps(dict(
        arch=TRAIN_ARCH, params=n_params, losses=losses,
        grad_norms=[h["grad_norm"] for h in hist],
        step_ms=[h["seconds"] * 1e3 for h in hist],
        step_ms_median=step_ms, tokens_per_s=tokens / step_ms * 1e3,
        bound_ms=bound, bound_matmul_ms=mm_ms, peak_gb=peak)), flush=True)
    del state, trainer, model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    train_smoke_archs(torch)
    log(f"[train/smoke] ten smoke configs in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt:
        for steps, want in ((20, None), (30, f"[trainer] restored step 20 "
                                             f"from {ckpt}")):
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 TRAIN_ARCH, "--smoke", "--steps", str(steps),
                 "--ckpt-every", "10", "--ckpt-dir", ckpt],
                capture_output=True, text=True, timeout=300,
                env=dict(os.environ, PYTHONPATH=str(SRC)))
            for line in out.stdout.splitlines():
                log(f"[train/cli] {line}")
            last = out.stdout.splitlines()[-1:] or [""]
            if out.returncode != 0 or not last[0].startswith(
                    f"[train] done at step {steps}; loss ") or (
                    want is not None and want not in out.stdout.splitlines()):
                raise AssertionError(f"launch.train --steps {steps} exited "
                                     f"{out.returncode}:\n"
                                     f"{out.stderr[-4000:]}")
    log(f"[train/cli] ran and resumed in {time.perf_counter() - t0:.1f}s")
    log(f"[train] phase 5e {time.perf_counter() - t_phase:.1f}s")


def run_train_process() -> None:
    """Phase 5e in a process of its own; its failure fails the smoke."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--train-only"], timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the training phase exited {out.returncode}")
    log(f"[train] process done in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 5f: the LM dry run and the production-mesh training step, in a
# process of its own (``--dryrun-only``)
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("tinyllama_1_1b", "train_4k"),
                ("tinyllama_1_1b", "prefill_32k"),
                ("tinyllama_1_1b", "decode_32k"),
                ("llama3_405b", "train_4k"))
# (b): the sharded step's loss and grad norm = the plain step's (relative)
DRYRUN_STEP_RTOL = 1e-3
# (c): |dry-run peak − measured peak| / measured peak
DRYRUN_PEAK_TOL = 0.25
# phase 5g: the separated iteration's wave, the 2-D count's queries, and
# the file its launches reach the kernel table through
JOIN_WAVE = 256
NLJ2D_QUERIES = 2_000
JOIN_LAUNCHES = ROOT / "build" / "dryrun" / "join_launches.json"


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_dryrun_cells() -> list:
    """DRYRUN_CELLS and (phase 5g (a)) the join cells through ``python -m
    repro_torch.launch.dryrun``, all at once, each in a process of its own
    (the fake group is process-global)."""
    from repro_torch.configs.vectorjoin import JOIN_DRYRUN_CELLS
    out_dir = ROOT / "build" / "dryrun"     # build/ is ignored by git
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = [(arch, shape, ["--arch", arch, "--shape", shape])
            for arch, shape in DRYRUN_CELLS]
    runs += [(c.name, "join_wave", ["--join", c.name, "--device", "cpu"])
             for c in JOIN_DRYRUN_CELLS]
    procs = []
    for arch, shape, argv in runs:
        out = out_dir / f"dryrun_{arch}_{shape}.json"
        with open(out.with_suffix(".log"), "w") as f:
            procs.append((arch, shape, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
                 "--out", str(out)],
                stdout=f, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(SRC)))))
    return procs


def finish_dryrun_cells(procs) -> list:
    """Wait for ``start_dryrun_cells``' processes → their results, logged;
    a cell that raised fails."""
    results = []
    for arch, shape, out, p in procs:
        p.wait(timeout=300)
        text = out.with_suffix(".log").read_text()
        for line in text.splitlines():
            if line.startswith(("[dryrun]", "  cost:")):
                log(f"[dryrun/cell] {line}")
        if p.returncode != 0:
            raise AssertionError(f"dry run {arch} x {shape} exited "
                                 f"{p.returncode}:\n{text[-4000:]}")
        results.append(json.loads(out.read_text())[0])
    for r in results:
        log(f"[dryrun] {r['arch']} x {r['shape']} on {r['mesh']}: "
            f"{r['peak_memory_bytes'] / 1e9:.6g} GB/dev of 80; compute "
            f"{r['compute_s']:.6g}s memory {r['memory_s']:.6g}s collective "
            f"{r['collective_s']:.6g}s, bound {r['bottleneck']}; step_s "
            f"{r['step_s']:.6g} step_min_s {r['step_min_s']:.6g}; roofline "
            f"{r['roofline_fraction']:.4g}; traced in {r['trace_s']}s "
            f"(the model's prediction for the H100 spec)")
    return results


def run_dryrun(torch, smi: str, *, cells: bool = True) -> None:
    """Phase 5f (see the module docstring); without ``cells`` its part (a)
    is left to the caller (``run_dryrun_process``)."""
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (close_group, make_local_mesh,
                                         open_fake_group)
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.roofline import analyze
    from repro_torch.roofline.cost import CostCounter
    from repro_torch.train import make_train_step
    from repro_torch.train.loop import sharded_train_step

    t_phase = time.perf_counter()
    procs = start_dryrun_cells() if cells else None  # (a), beside (b), (c)
    mc = get(TRAIN_ARCH).model
    shape = ShapeSpec("train_2k", "train", TRAIN_SEQ, TRAIN_BATCH)

    # (c), the model's side: the same cell on a (1, 1) mesh of a fake group
    t0 = time.perf_counter()
    open_fake_group(1)
    try:
        mesh = make_local_mesh(1, device_type=DEV)
        cost, peak = dryrun.trace_cost(mc, mesh, shape,
                                       microbatches=TRAIN_MICRO, device=DEV)
    finally:
        close_group()
    model_r = analyze(arch=TRAIN_ARCH, shape=shape.name, mesh_name="1x1",
                      n_devices=1, cost=cost,
                      model_flops=6.0 * M.active_param_count(mc)
                      * TRAIN_BATCH * TRAIN_SEQ, peak_memory=peak)
    log(f"[dryrun/1x1] traced in {time.perf_counter() - t0:.1f}s: flops "
        f"{cost.flops:.17g}, peak {peak / 1e9:.3f} GB, step_min_s "
        f"{model_r.step_min_s:.6g}, step_s {model_r.step_s:.6g}")

    # (b): two sharded steps on a (1, 1) mesh of a real one-rank group
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, device_type=DEV)
        src = SyntheticLM(vocab=mc.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)
        batches = [{k: torch.from_numpy(v).to(DEV)
                    for k, v in src.batch_at(i).items()} for i in range(2)]
        lr = warmup_cosine(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
        runs = {}
        for kind in ("sharded", "plain"):
            model = M.init_params(mc, device=DEV, generator=torch.Generator(
                device=DEV).manual_seed(0))
            opt = adamw(moment_dtype=torch.bfloat16)
            if kind == "sharded":
                step, pls, _ = sharded_train_step(
                    mc, opt, lr, mesh, microbatches=TRAIN_MICRO)
                S.distribute_model(model, mesh, placements_of=pls)
            else:
                step = make_train_step(mc, opt, lr, microbatches=TRAIN_MICRO)
            state = opt.init(dict(model.named_parameters()))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hist = []
            for i, batch in enumerate(batches):
                counted = kind == "sharded" and i == 1
                cc = CostCounter()
                t0 = time.perf_counter()
                if counted:
                    with cc:
                        model, state, m = step(model, state, batch, i)
                else:
                    model, state, m = step(model, state, batch, i)
                m = {k: float(m[k]) for k in ("loss", "grad_norm")}
                hist.append(dict(m, ms=(time.perf_counter() - t0) * 1e3,
                                 flops=cc.flops if counted else None))
                if i == 0:
                    hist[0]["peak"] = torch.cuda.max_memory_allocated()
            runs[kind] = hist
            del model, state, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    gaps = [max(abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm"))
            for a, b in zip(runs["sharded"], runs["plain"])]
    for i, (a, b) in enumerate(zip(runs["sharded"], runs["plain"])):
        log(f"[dryrun/step] step {i}: sharded loss {a['loss']!r} grad norm "
            f"{a['grad_norm']!r} ({a['ms']:.1f} ms); plain loss "
            f"{b['loss']!r} grad norm {b['grad_norm']!r} ({b['ms']:.1f} ms); "
            f"relative gap {gaps[i]:.3g}")
    if not max(gaps) <= DRYRUN_STEP_RTOL:
        raise AssertionError(f"the (1, 1) sharded step is not the plain "
                             f"step: gaps {gaps}")
    real_flops = runs["sharded"][1]["flops"]
    measured = runs["sharded"][0]["peak"]
    off = abs(peak - measured) / measured
    log(f"[dryrun/cost] counted flops: real step {real_flops:.17g}, dry run "
        f"{cost.flops:.17g}; peak: dry run {peak / 1e9:.3f} GB, measured "
        f"{measured / 1e9:.3f} GB (off {off:.4f}, limit {DRYRUN_PEAK_TOL}); "
        f"sharded step {runs['sharded'][0]['ms']:.1f} ms measured against "
        f"the model's step_min_s {model_r.step_min_s * 1e3:.1f} ms ({smi})")
    if real_flops != cost.flops:
        raise AssertionError(f"counted flops differ: real {real_flops}, "
                             f"dry run {cost.flops}")
    if off > DRYRUN_PEAK_TOL:
        raise AssertionError(f"dry-run peak {peak} vs measured {measured}")

    print("[dryrun] " + json.dumps(dict(
        step=runs, gaps=gaps, dry_flops=cost.flops, dry_peak=peak,
        dry_step_min_s=model_r.step_min_s, dry_step_s=model_r.step_s)),
        flush=True)
    log(f"[dryrun] phase 5f {time.perf_counter() - t_phase:.1f}s")
    del runs
    torch.cuda.empty_cache()
    run_join_dryrun(torch, smi)
    if procs is not None:
        report_dryrun_cells(procs)


def run_join_dryrun(torch, smi: str) -> None:
    """Phase 5g (b) and (c) (see the module docstring); its launches go to
    JOIN_LAUNCHES for the kernel table."""
    from repro_torch.configs.vectorjoin import EngineSpec, JoinCell
    from repro_torch.core import JoinConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.vectors import table1_dataset, thresholds
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dryrun
    from repro_torch.roofline.cost import CostCounter

    t_phase = time.perf_counter()
    ds = table1_dataset("sift-like", n_data=MAIN_N_DATA,
                        n_query=MAIN_N_QUERY, seed=0)
    theta = float(thresholds(ds, 7)[1])
    Y = torch.as_tensor(ds.Y, device=DEV)

    # (b) one separated iteration of the mesh MI join, f32 and bf16
    X = torch.as_tensor(ds.X[:JOIN_WAVE], device=DEV)
    t0 = time.perf_counter()
    smi = D.build_sharded_merged_index(Y, X, SHARDS, devices=(DEV,) * SHARDS,
                                       **EngineSpec().build_kw())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qids = torch.arange(JOIN_WAVE, dtype=torch.int32, device=DEV)
    lv = torch.ones(JOIN_WAVE, dtype=torch.bool, device=DEV)
    cfg = JoinConfig().traversal
    launches = {}
    for tag, dt, kernel in (("f32", torch.float32, "gather_sq_dists"),
                            ("bf16", torch.bfloat16, "gather_sq_dists_bf16")):
        s = smi if dt == torch.float32 else dataclasses.replace(
            smi, shards=tuple(dataclasses.replace(g, vecs=g.vecs.to(dt))
                              for g in smi.shards))
        x = X.to(dt).clone()
        kw = dict(theta=theta, cfg=cfg)
        # the dry run's trace of one shard of these shapes, as its rows
        cell = JoinCell("smoke", n_query=smi.n_query,
                        n_data=SHARDS * smi.shard_size, dim=x.shape[1],
                        degree=smi.shards[0].degree, wave_size=JOIN_WAVE,
                        pool_cap=cfg.pool_cap, max_iters=cfg.max_iters,
                        dtype=str(dt).removeprefix("torch."))
        fake, _ = dryrun.trace_join_wave(cell, n_shards=SHARDS, device=DEV)
        fake = fake * SHARDS
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with CostCounter() as cc:
            D.mesh_mi_iteration(s, x, qids, lv, **kw)
        torch.cuda.synchronize()
        counted_ms = (time.perf_counter() - t0) * 1e3
        real = cc.snapshot()
        got = ops.launch_counts()
        add_launches(launches, got)
        t0 = time.perf_counter()
        D.mesh_mi_iteration(s, x, qids, lv, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        log(f"[dryrun/join] one separated iteration, {SHARDS} logical shards "
            f"of {smi.shard_size} rows, a wave of {JOIN_WAVE}, {tag}: counted "
            f"flops real {real.flops:.17g} fake {fake.flops:.17g}; bytes real "
            f"{real.bytes:.17g} fake {fake.bytes:.17g}; ops real "
            f"{real.n_ops} fake {fake.n_ops} (fake: {SHARDS} x one shard's "
            f"trace, without the combine's copy); {kernel} launched "
            f"{got[kernel]} times; {plain_ms:.2f} ms (host clock, "
            f"{counted_ms:.2f} under the counter); shard builds "
            f"{build_s:.1f}s ({SHARDS} x {tuple(smi.shards[0].vecs.shape)})")
        if got[kernel] == 0:
            raise AssertionError(f"the separated iteration never launched "
                                 f"{kernel}")
        if real.flops != fake.flops:
            raise AssertionError(f"the {tag} iteration's counted flops "
                                 f"differ from its fake trace: {real.flops} "
                                 f"!= {fake.flops}")
        if dt == torch.bfloat16:
            # the bf16 entry against its plain version on the iteration's
            # probe rows and on a half-NO_NODE expansion's ids
            g = s.shards[0]
            inp = Inputs(torch)
            for what, idx in (("probe rows", g.nbrs[(qids + smi.shard_size)
                                                    .long()]),
                              ("expansion ids", inp.ids(
                                  JOIN_WAVE, cfg.expand_per_iter * g.degree,
                                  g.n_nodes, 0.5))):
                err = check_bf16_gather(torch, ops, ref, g.vecs, x, idx, what)
                log(f"[dryrun/join] bf16 gather at the iteration's {what} "
                    f"{tuple(idx.shape)}: max |kernel − plain| {err}")
    del smi, s, X

    # (c) the 2-D count: rows over 4 data shards, dims over 2 model ranks
    Xc = torch.as_tensor(ds.X[:NLJ2D_QUERIES], device=DEV)
    mesh = D.DeviceMesh.on_device(DEV, 8, (4, 2), ("data", "model"))
    count = D.make_distributed_nlj_count(mesh, "data", "model", theta=theta)
    t0 = time.perf_counter()
    got = count(Xc, Y)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ops.reset_launch_counts()
    want = ops.nlj_count(Xc, Y, theta=theta)
    torch.cuda.synchronize()
    nl = ops.launch_counts()
    if nl["nlj_count"] == 0:
        raise AssertionError("the 2-D count check never launched nlj_count")
    add_launches(launches, nl)
    rows = (got.long() != want.long()).nonzero().squeeze(1)
    ulp = float(np.spacing(np.float32(theta)))
    off = 0
    for q in rows.tolist():
        d64 = ((Y.double() - Xc[q].double()) ** 2).sum(1).sqrt()
        band = int(((d64 - theta).abs() <= 16 * ulp).sum())
        diff = abs(int(got[q]) - int(want[q]))
        if diff > band:
            raise AssertionError(f"2-D count: query {q} counts {int(got[q])}"
                                 f", nlj_count {int(want[q])}, beyond its "
                                 f"{band} pairs within 16 ulps of θ")
        off += diff
    log(f"[dryrun/join] make_distributed_nlj_count on a (4, 2) mesh of "
        f"logical shards, {NLJ2D_QUERIES} queries x {MAIN_N_DATA} rows: "
        f"{int(got.sum())} pairs ({secs:.3f}s) against nlj_count's "
        f"{int(want.sum())}; {rows.numel()} queries differ, by {off} pairs, "
        f"each within 16 ulps of θ")
    JOIN_LAUNCHES.write_text(json.dumps(launches))
    log(f"[dryrun/join] phase 5g (b), (c) {time.perf_counter() - t_phase:.1f}s")


def report_dryrun_cells(procs) -> None:
    """Wait for phase 5f's cells and print their JSON line."""
    t0 = time.perf_counter()
    cell_results = finish_dryrun_cells(procs)
    log(f"[dryrun] waited {time.perf_counter() - t0:.1f}s for the cells")
    print("[dryrun] " + json.dumps(dict(cells=[
        {k: r[k] for k in ("arch", "shape", "peak_memory_bytes", "compute_s",
                           "memory_s", "collective_s", "bottleneck",
                           "step_s", "step_min_s", "roofline_fraction",
                           "trace_s")} for r in cell_results])), flush=True)


def run_dryrun_process(procs) -> None:
    """Phase 5f in a process of its own, its cells (``procs``, started by
    the caller while phase 5e used the card: they need only the host's
    CPU) waited for here; its failure fails the smoke."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--dryrun-only", "--no-cells"], timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the dry-run phase exited {out.returncode}")
    report_dryrun_cells(procs)
    log(f"[dryrun] process done in {time.perf_counter() - t0:.1f}s")


def check_launched(run: dict, kernels) -> None:
    """Every kernel of the path was launched during its join (build
    included)."""
    missing = [k for k in kernels if run["launches"][k] == 0]
    if missing:
        raise AssertionError(f"{run['name']} path never launched {missing}")


def profile_join(torch, run: dict) -> None:
    """The overlap-off join of the first PROFILE_QUERIES queries under
    torch.profiler (device kernels only): device busy time against the
    unprofiled wall time of the same join, and the kernels that take it.
    (The profiler's own processing of a whole join's half-million device
    ops takes over a minute.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    name, eng = run["name"], run["eng"]
    X = run["X"][:PROFILE_QUERIES]
    eng.merged_index(X)                       # built outside the window
    t0 = time.perf_counter()
    eng.join(X, run["cfg"])
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.join(X, run["cfg"])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    log(f"[{name}] profiled overlap-off join of {X.shape[0]} queries: "
        f"device busy {busy:.3f}s; unprofiled wall {seq_s:.2f}s (busy share "
        f"{busy / seq_s:.3f}); profiled wall {wall:.2f}s; "
        f"{sum(e.count for e in rows)} device ops")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[{name}]   {e.self_device_time_total / 1e6:8.3f}s "
            f"x{e.count:<8d} {e.key[:100]}")


def trace_pair_block(torch) -> None:
    """One pair block of the NLJ's escalation (``join.escalate_block``:
    the int8 tier's ``pair_refine``, the band split, the f32 re-rank of the
    band) under torch.profiler: PAIR_BLOCK pairs over an NLJ_QBLOCK-query
    block and MAIN_N_DATA random rows (d = 128), each passed by tier 0
    with lower bound 0, θ² at the 1st percentile of the int8 lower bounds
    (a sparse band, as at the main path's θ). Logs the unprofiled wall
    time of a block, its device time, the share of the port's kernels
    (``csrc/``, in anonymous namespaces; torch's are in ``at::native``)
    and the costliest device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.join import escalate_block
    from repro_torch.quant.cascade import Int8Tier
    from repro_torch.quant.store import build_store
    inp = Inputs(torch)
    Y, xb = inp.rn(MAIN_N_DATA, 128), inp.rn(NLJ_QBLOCK, 128)
    tier = Int8Tier(build_store(Y))
    qc = tier.encode(xb)
    qi, yi = (t.long() for t in nlj_pair_block(torch, inp, MAIN_N_DATA))
    lb0 = tier.pair_refine(qc, qi, yi)[0]
    th2 = float(lb0.kthvalue(qi.numel() // 100).values)
    plb = torch.zeros_like(lb0)
    del lb0
    counts = {"escalated": [0], "n_rerank": 0}

    def block():
        return escalate_block([tier], [qc], xb, Y, qi, yi, plb, 0, th2, None,
                              counts)
    n = 5
    block()
    torch.cuda.synchronize()
    counts["n_rerank"] = 0
    t0 = time.perf_counter()
    for _ in range(n):
        block()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            block()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = kernel_us(prof, DeviceType) / n / 1e3
    ours = sum(e.self_device_time_total for e in rows
               if "(anonymous namespace)::" in e.key
               and "at::native" not in e.key) / n / 1e3
    log(f"[trace] NLJ pair block ({qi.numel()} pairs, band "
        f"{counts['n_rerank'] / n:.0f}): unprofiled wall {wall:.4f} ms a "
        f"block; device {busy:.4f} ms ({busy / wall:.3f} of the wall), the "
        f"port's kernels {ours:.4f} ms, torch's ops {busy - ours:.4f} ms; "
        f"{sum(e.count for e in rows) / n:.1f} device ops a block")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[trace]   {e.self_device_time_total / n / 1e3:9.4f} ms "
            f"x{e.count / n:5.1f} {e.key[:100]}")


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
    from repro_torch.configs.vectorjoin import EngineSpec
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

    if "--lm-only" in sys.argv[1:]:
        run_lm(torch, smi)                   # phase 5d alone: no kernels
        log(f"[done] LM only, {time.perf_counter() - t_all:.1f}s")
        return 0                             # no contract line: not the run
    if "--train-only" in sys.argv[1:]:
        run_train(torch, smi)                # phase 5e alone: no kernels
        log(f"[done] training only, {time.perf_counter() - t_all:.1f}s")
        return 0                             # no contract line: not the run
    if "--dryrun-only" in sys.argv[1:]:
        # phase 5f alone (its cells too, unless --no-cells): no kernels
        run_dryrun(torch, smi, cells="--no-cells" not in sys.argv[1:])
        log(f"[done] dry run only, {time.perf_counter() - t_all:.1f}s")
        return 0                             # no contract line: not the run
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds}s)")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    check_kernels(torch, ops, ref)
    check_kernels_sq8(torch, ops, ref)
    check_kernels_sketch_pdx(torch, ops, ref)
    check_kernels_nlj(torch, ops, ref)
    if "--kernels-only" in sys.argv[1:]:
        log(f"[done] kernels only, {time.perf_counter() - t_all:.1f}s")
        return 0                             # no contract line: not the run
    if "--sharded-only" in sys.argv[1:]:
        # phase 3e alone on the main path's data (no main-path join)
        run_sharded(torch, ops, sharded_inputs(torch))
        log(f"[done] sharded only, {time.perf_counter() - t_all:.1f}s")
        return 0                             # no contract line: not the run
    log(f"[sync] one loop check (reduce + device→host bool) "
        f"{sync_us(torch):.1f} µs")

    # the 1M-row joins skip their overlap-off reruns (19-27 s each), the
    # smoke's time limit (PERF.md §7); the OOD joins, the search path, the
    # streams and the sharded join still hold overlap on = off
    main_run = run_join(torch, ops, "sift-like", MAIN_N_DATA, MAIN_N_QUERY, 1,
                        overlap_off=False)
    if main_run["recall"] < MAIN_RECALL_FLOOR:
        raise AssertionError(f"main path recall {main_run['recall']} below "
                             f"the floor {MAIN_RECALL_FLOOR}")
    check_launched(main_run, F32_KERNELS)
    nlj_check = check_nlj_count_main(torch, ops, main_run)
    search = run_search(torch, ops, main_run)
    stream = run_stream(torch, ops, main_run)
    serve = run_serve(torch, ops, main_run)
    sharded = run_sharded(torch, ops, main_run)
    del main_run["eng"], main_run["pairs"]    # free the 1M-row indexes

    sq8 = EngineSpec(quant="sq8", quant_build="sq8")
    sq8_run = run_join(torch, ops, "sift-like", MAIN_N_DATA, MAIN_N_QUERY, 1,
                       spec=sq8, base=main_run, overlap_off=False)
    check_launched(sq8_run, SQ8_KERNELS)
    check_knn_ties(sq8_run, main_run)
    log(f"[sift-like] recall f32 {main_run['recall']:.6f} sq8 "
        f"{sq8_run['recall']:.6f}; ms_per_iter f32 "
        f"{main_run['ms_iter']:.3f} sq8 {sq8_run['ms_iter']:.3f}")
    sq8_nlj = check_nlj(torch, ops, sq8_run, SQ8_NLJ_KERNELS)
    del main_run["knn"], sq8_run["knn"]
    # phase 4b: sketch8 (= serving_sketch8: its quant_build is sq8 too)
    # and pdx8 on the sq8 engine's merged index
    # the 1M-row sketch8 and pdx8 joins skip their overlap-off and
    # (pdx8) early-exit-off reruns too; the OOD sketchpdx8 join keeps
    # both, and the pdx8 NLJ its early exit on = off
    sk8 = run_mode(torch, ops, sq8_run, "sketch8",
                   floor=SKETCH8_RECALL_FLOOR, kernels=SKETCH8_KERNELS,
                   nlj_kernels=SKETCH8_NLJ_KERNELS, reruns=False)
    pd8 = run_mode(torch, ops, sq8_run, "pdx8", floor=PDX8_RECALL_FLOOR,
                   kernels=PDX8_KERNELS, nlj_kernels=PDX8_NLJ_KERNELS,
                   reruns=False)
    log(f"[sift-like] recall sq8 {sq8_run['recall']:.6f} sketch8 "
        f"{sk8['recall']:.6f} pdx8 {pd8['recall']:.6f}")
    del sq8_run["eng"]

    ood_run = run_join(torch, ops, "laion-like", OOD_N_DATA, OOD_N_QUERY, 2)
    if ood_run["n_ood"] <= 0:
        raise AssertionError("OOD phase flagged no query: the hybrid BBFS "
                             "did not run")
    check_launched(ood_run, F32_KERNELS)
    ood8 = run_join(torch, ops, "laion-like", OOD_N_DATA, OOD_N_QUERY, 2,
                    spec=sq8, base=ood_run)
    if ood8["n_ood"] <= 0:
        raise AssertionError("sq8 OOD phase flagged no query")
    check_launched(ood8, SQ8_KERNELS)
    log(f"[laion-like] recall f32 {ood_run['recall']:.6f} sq8 "
        f"{ood8['recall']:.6f}")
    # phase 5b: sketchpdx8 on the OOD sq8 engine's merged index
    skpd = run_mode(torch, ops, ood8, "sketchpdx8",
                    floor=OOD_SKETCHPDX8_RECALL_FLOOR,
                    kernels=SKETCHPDX8_KERNELS,
                    nlj_kernels=SKETCHPDX8_NLJ_KERNELS)
    stream_mi = run_stream_mi(torch, ops, ood8)
    del ood8["eng"]
    torch.cuda.empty_cache()
    run_lm_process()
    # 5f's dry-run cells trace on the host's CPU while 5e uses the card
    cells = start_dryrun_cells()
    try:
        run_train_process()
        run_dryrun_process(cells)
    finally:
        for *_, p in cells:
            if p.poll() is None:
                p.kill()

    table = time_kernels(torch, ops, ref, pd8["band_frac"])
    trace_pair_block(torch)
    profile_join(torch, ood_run)

    replaces = {
        "pairwise_sq_dists": "src/repro/kernels/distance.py:54",
        "pairlist_sq_dists": "src/repro/kernels/distance.py:54",
        "rowwise_sq_dists": "src/repro/kernels/distance.py:106",
        "gather_sq_dists": "src/repro/kernels/gather_distance.py:47",
        "gather_sq_dists_bf16": "src/repro/kernels/gather_distance.py:47",
        "gather_sq_dists_pairs": "src/repro/kernels/gather_distance.py:47",
        "topk_merge": "src/repro/kernels/topk_merge.py:70",
        "pairwise_sq_dists_int8": "src/repro/kernels/int8.py:64",
        "pairwise_bounds_int8": "src/repro/kernels/int8.py:64",
        "rowwise_sq_dists_int8": "src/repro/kernels/int8.py:119",
        "gather_bounds_int8": "src/repro/kernels/int8.py:119",
        "gather_bounds_int8_pairs": "src/repro/kernels/int8.py:119",
        "pairwise_hamming": "src/repro/kernels/bits.py:56",
        "rowwise_hamming": "src/repro/kernels/bits.py:93",
        "pairwise_sq_dists_pdx": "src/repro/kernels/pdx.py:116",
        "pairwise_bounds_pdx": "src/repro/kernels/pdx.py:116",
        "pdx_gather_sq_dists": "src/repro/kernels/pdx.py:222",
        "nlj_count": "src/repro/kernels/nlj.py:50",
        "gather_sketch_bounds": "src/repro/kernels/bits.py:93",
        "pdx_compact_gather": "src/repro/kernels/pdx.py:222",
    }
    source = {k: "src/repro_torch/kernels/csrc/distance.cu" for k in
              ("pairwise_sq_dists", "pairlist_sq_dists", "rowwise_sq_dists",
               "gather_sq_dists", "gather_sq_dists_bf16",
               "gather_sq_dists_pairs")}
    source.update({k: "src/repro_torch/kernels/csrc/int8.cu" for k in
                   ("pairwise_sq_dists_int8", "pairwise_bounds_int8",
                    "rowwise_sq_dists_int8", "gather_bounds_int8",
                    "gather_bounds_int8_pairs")})
    source["topk_merge"] = "src/repro_torch/kernels/csrc/topk_merge.cu"
    source.update({k: "src/repro_torch/kernels/csrc/bits.cu"
                   for k in ("pairwise_hamming", "rowwise_hamming",
                             "gather_sketch_bounds")})
    source.update({k: "src/repro_torch/kernels/csrc/pdx.cu"
                   for k in ("pairwise_sq_dists_pdx", "pairwise_bounds_pdx",
                             "pdx_gather_sq_dists", "pdx_compact_gather")})
    source["nlj_count"] = "src/repro_torch/kernels/csrc/nlj.cu"
    paths = {"f32": main_run["launches"], "sq8": sq8_run["launches"],
             "sq8/nlj": sq8_nlj["launches"]}
    paths.update({m: r["launches"] for m, r in search.items()})
    paths["nlj_check"] = nlj_check
    paths.update(stream)
    paths.update(serve)
    paths.update(sharded)
    paths["stream/es_mi_adapt/sq8"] = stream_mi
    paths["dryrun/join"] = json.loads(JOIN_LAUNCHES.read_text())
    # the sketch/PDX paths: their merged-index join plus their NLJ
    for r in (sk8, pd8, skpd):
        paths[r["name"].split("/")[1]] = {
            k: r["launches"][k] + r["nlj_launches"][k] for k in r["launches"]}
    kernels = [dict(name=k, route="cuda", source=source[k],
                    replaces=replaces[k],
                    launches=sum(p[k] for p in paths.values()),
                    launches_by_path={n: p[k] for n, p in paths.items()},
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    **{x: r[x] for x in ("ms_exit_off", "composition_ms",
                                         "composition_event_ms", "parent_ms",
                                         "parent_bound_ms", "event_ms",
                                         "op_event_ms") if x in r})
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
