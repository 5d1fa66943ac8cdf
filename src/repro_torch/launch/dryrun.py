"""Multi-pod dry run (port of ``repro.launch.dryrun``): trace one rank of
every (architecture × shape) cell on the H100 production mesh and extract
the roofline terms from what it ran.

The reference lowers and compiles each cell for 512 placeholder devices
(GSPMD) and reads the compiled artifact. The port does what torch offers
for the same question: a *fake* process group of 256 (or 512) ranks, a
``DeviceMesh`` on it (``launch/mesh.py``), the model's parameters as
DTensors placed by ``models/sharding.py``, and the cell's step run once
under ``FakeTensorMode``: shapes, dtypes and placements are real, nothing
is allocated and every collective is a no-op. ``roofline.cost.CostCounter``
records the rank's local ops under DTensor (FLOPs, bytes, collectives)
and the peak of the bytes its live tensors hold. It needs no card, as the
reference needs no TPU: ``--device`` names the fake tensors' device
(``cuda`` by default, ``cpu`` in tests). Run it as its own process: the
fake group is process-global.

Per cell:
  train_4k     → the full production train step (forward, backward and
                 the AdamW update with bf16 moments, micro-batches);
  prefill_32k  → prefill (forward + KV-cache emit);
  decode_32k   → one decode step with a seq-long KV cache;
  long_500k    → a decode step with a 500k cache (sequence-sharded KV).

A join cell (``--join``, ``configs.vectorjoin.JOIN_DRYRUN_CELLS``) is
one rank's wave of the mesh MI join with X replicated and Y sharded over
the data axes (``("pod", "data")`` multi-pod): the shard's merged index
as fake tensors, the probe, one traversal iteration
(``core.distributed.local_mi_iteration``, no host sync), the band
compaction and the pool combine, an all-gather over the data axes. Its
FLOPs and bytes are scaled by the cell's expected iterations, its
collective counted once, as the reference scales its lowered iteration.

Every figure a cell prints is the model's prediction for the H100 spec
(``roofline/hw.py``), not a measurement.

Examples:
  python -m repro_torch.launch.dryrun --arch tinyllama_1_1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out dryrun.json
  python -m repro_torch.launch.dryrun --join join_sift_like
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import sys
import time

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import SHAPES, get, input_specs, supported
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.vectorjoin import JOIN_DRYRUN_CELLS, JoinCell
from repro_torch.launch.mesh import close_group, make_production_mesh
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.roofline import analyze, model_flops_estimate
from repro_torch.roofline.cost import Cost, CostCounter
from repro_torch.train.loop import MICROBATCH_SPAN, sharded_train_step

# grad-accum microbatch counts sized so per-microbatch activations fit
# (≈ global_batch·seq/(mb·dp) tokens in flight per device), the
# reference's
MICROBATCHES = {
    "llama3_405b": 16, "qwen2_vl_72b": 8, "qwen3_moe_235b_a22b": 8,
    "deepseek_v2_236b": 8, "jamba_1_5_large_398b": 8, "gemma2_9b": 4,
    "rwkv6_7b": 4, "h2o_danube_3_4b": 4, "tinyllama_1_1b": 2,
    "hubert_xlarge": 2,
}

# √G two-level remat for the deep dense train cells, the reference's
REMAT_2LEVEL = {"llama3_405b", "qwen2_vl_72b"}

# local ops one trace may dispatch (the largest cells' traces run ~10x
# fewer): a guard against a loop of eager ops over tokens, such as the
# Mamba scan's before it became one op (``models.ssm.mamba_scan``)
MAX_OPS = 1_000_000


def fit_microbatches(mb: int, batch: int, dp: int) -> int:
    """The most micro-batches up to ``mb`` that split the batch into
    pieces that shard evenly over the ``dp`` data ranks (the (32, 8)
    mesh's 32 data ranks take 16 micro-batches of 256 sequences, the
    reference's (16, 16) mesh's 16 take 16)."""
    while mb > 1 and (batch % mb or (batch // mb) % dp):
        mb -= 1
    return mb


def _distributed(mc, mesh, device):
    model = M.Model(mc, layers.ParamInit("meta"))
    S.distribute_model(model, mesh, device=device)
    return model


def _place_caches(caches, mesh, batch):
    """Decode caches laid out by ``cache_specs``: a DTensor (prefill's)
    redistributed, a stand-in replaced by a shard of its own."""
    specs = S.cache_specs(caches, mesh, batch=batch)
    return [{n: S.place(t, mesh, S.placements(sp[n], mesh))
             for n, t in c.items()} for c, sp in zip(caches, specs)]


def _train(mc, mesh, shape, cc, *, microbatches, seq_parallel, device):
    opt = adamw(moment_dtype=torch.bfloat16)
    lr = warmup_cosine(peak_lr=3e-4, warmup_steps=2000, total_steps=500_000)
    step_fn, _, _ = sharded_train_step(mc, opt, lr, mesh,
                                       microbatches=microbatches,
                                       seq_parallel=seq_parallel)
    model = _distributed(mc, mesh, device)
    opt_state = opt.init(dict(model.named_parameters()))
    batch = input_specs(mc, shape, device)
    cc.track(dict(model.named_parameters()), opt_state)
    with cc:
        step_fn(model, opt_state, batch, 0)


def _serve(mc, mesh, shape, cc, *, seq_parallel, device):
    model = _distributed(mc, mesh, device)
    ins = input_specs(mc, shape, device)
    sharder = S.make_act_sharder(mesh, seq_parallel=seq_parallel)
    sb = lambda x: S.shard_batch(x, mesh)
    if shape.kind == "prefill":
        args = [sb(ins["inputs"]), sb(ins["positions"])]
    else:
        caches = _place_caches(ins["caches"], mesh, shape.batch)
        args = [sb(ins["tokens"]), sb(ins["positions"]), caches,
                sb(ins["cache_index"])]
    cc.track(dict(model.named_parameters()), args)
    with cc, implicit_replication(), M.activation_sharding(
            sharder, S.make_param_pinner(mesh)):
        if shape.kind == "decode":
            out = M.decode_step(model, *args)
        elif mc.encoder_only:
            out = M.logits_fn(model, M.forward(model, *args))
        else:
            logits, caches = M.prefill(model, *args, shape.seq)
            out = logits, _place_caches(caches, mesh, shape.batch)
    return model, args, out


def _trace(mc, mesh, shape, *, microbatches, seq_parallel, device,
           max_ops) -> tuple[Cost, list, int, int]:
    """One step run on fake tensors → (its cost, each micro-batch's cost,
    the peak bytes held, the bytes held after a serving step: its
    parameters, inputs and outputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cc = CostCounter(max_ops=max_ops, spans=(MICROBATCH_SPAN,))
    held = 0
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            if shape.kind == "train":
                _train(mc, mesh, shape, cc, microbatches=microbatches,
                       seq_parallel=seq_parallel, device=device)
            else:
                kept = _serve(mc, mesh, shape, cc,
                              seq_parallel=seq_parallel, device=device)
                held = cc.live_bytes
                del kept
    finally:
        # cached constants made under the fake mode must not outlive it
        layers._freqs.cache_clear()
        layers._section_ids.cache_clear()
    return cc.snapshot(), cc.spans[MICROBATCH_SPAN], cc.peak_bytes, held


def trace_cost(mc, mesh, shape, *, microbatches: int = 1,
               seq_parallel: bool = False, device: str = "cuda"
               ) -> tuple[Cost, int]:
    """The cost and the peak bytes of one rank's step of ``shape`` on
    ``mesh`` (a fake group's).

    Every layer group runs the same ops on the same shapes, and so does
    every micro-batch after the first, so a few groups are traced and the
    rest counted as whole repeats (the reference scales a scan body by its
    trip count): the full step's FLOPs, collectives and ops exactly, its
    bytes but for the few bytes a micro-batch that the metrics' means
    read. The step is traced with 1 and with 2 groups, a training step
    with at most 2 micro-batches (micro-batch 1 repeated). A training
    step's peak grows as those two peaks do: parameters, optimizer state,
    grads and the saved group boundaries grow by a fixed amount a group. A
    serving step's peak grows by what a group leaves held (its parameters
    and caches): its first group's peak lacks a hidden state the later
    ones see.

    ``2level`` remat is traced as ``full`` (one checkpoint a group), plus
    what it adds: the backward of each chunk of c groups runs c − 1 group
    forwards more than ``full`` does. 4 groups make 2 chunks of 2, so a
    4-group ``2level`` trace costs 2 group forwards more than 4 ``full``
    groups (extrapolated). Its peak is the ``full`` one less the group
    boundaries it does not save (it keeps G/c + c of them, not G)."""
    P, G = len(mc.period), mc.n_groups
    train = shape.kind == "train"
    mt = min(microbatches, 2) if train else 1
    shape_t = (dataclasses.replace(shape, batch=shape.batch // microbatches
                                   * mt) if train else shape)

    def at(cfg, g):
        cost, mbs, peak, held = _trace(
            cfg.with_overrides(n_layers=g * P), mesh, shape_t,
            microbatches=mt, seq_parallel=seq_parallel, device=device,
            max_ops=MAX_OPS)
        if train and microbatches > mt:
            # micro-batch 1 again for each later one
            cost = cost + mbs[1] * (microbatches - mt)
        return cost, peak, held

    def depth(cfg):
        """(cost at G, cost at 1 group, its slope a group, peak at G)."""
        c1, p1, h1 = at(cfg, 1)
        if G == 1:
            return c1, c1, c1 - c1, p1
        c2, p2, h2 = at(cfg, 2)
        grow = p2 - p1 if train else h2 - h1
        return c1 + (c2 - c1) * (G - 1), c1, c2 - c1, p2 + grow * (G - 2)

    if mc.remat != "2level":
        cost, _, _, peak = depth(mc)
        return cost, peak
    cost, c1, slope, peak = depth(mc.with_overrides(remat="full"))
    c = M.remat_chunk(G)
    if c > 1:
        # two extra group forwards in a 4-group trace
        extra = at(mc, 4)[0] - (c1 + slope * 3)
        cost = cost + extra * ((G // c) * (c - 1) / 2)
    sizes = S.mesh_shape(mesh)
    dp = math.prod(n for a, n in sizes.items() if a != "model")
    b = shape.batch // microbatches
    b = b // dp if b % dp == 0 else b
    s = shape.seq // sizes["model"] if seq_parallel else shape.seq
    h = b * s * mc.d_model * mc.dtype.itemsize
    return cost, peak - (G - G // c - c) * (-(-h // 512) * 512)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             microbatches: int | None = None, verbose: bool = True,
             seq_parallel: bool = False, device: str = "cuda", mesh=None
             ) -> dict:
    """One cell on the production mesh (opened and closed here unless
    ``mesh`` is given) → the roofline as a dict, with ``trace_s``,
    ``microbatches`` and ``tokens``."""
    spec = get(arch)
    shape = SHAPES[shape_name]
    ok, why = supported(spec, shape_name)
    if not ok:
        return dict(arch=arch, shape=shape_name, skipped=True, reason=why)
    own = mesh is None
    if own:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    try:
        mesh_name = "x".join(map(str, mesh.shape))
        n_dev = mesh.size()
        dp = math.prod(n for a, n in S.mesh_shape(mesh).items()
                       if a != "model")
        mc = spec.model
        mb = fit_microbatches(microbatches or MICROBATCHES.get(arch, 4),
                              shape.batch, dp)
        if shape.kind == "train" and arch in REMAT_2LEVEL:
            mc = mc.with_overrides(remat="2level")
        t0 = time.time()
        cost, peak = trace_cost(mc, mesh, shape, microbatches=mb,
                                seq_parallel=seq_parallel, device=device)
        t_trace = time.time() - t0
    finally:
        if own:
            close_group()
    n_active = M.active_param_count(mc)
    tokens = (shape.batch * shape.seq if shape.kind != "decode"
              else shape.batch)
    mf = model_flops_estimate(kind=shape.kind, n_params_active=n_active,
                              tokens=tokens)
    r = analyze(arch=arch, shape=shape_name, mesh_name=mesh_name,
                n_devices=n_dev, cost=cost, model_flops=mf, peak_memory=peak)
    out = r.as_dict()
    out.update(skipped=False, trace_s=round(t_trace, 1), microbatches=mb,
               tokens=tokens, local_ops=round(cost.n_ops))
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} on {mesh_name}: trace "
              f"{t_trace:.0f}s, {peak / 1e9:.2f} GB/dev of "
              f"{r.hw.hbm_bytes / 1e9:.0f}, bound={r.bottleneck}, "
              f"step≈{r.step_s * 1e3:.1f} ms (min {r.step_min_s * 1e3:.1f}),"
              f" roofline {100 * r.roofline_fraction:.1f}%", flush=True)
        ck = {k: v for k, v in sorted(r.collectives.items())}
        print(f"  cost: flops/dev={r.flops_per_device:.4g} "
              f"bytes/dev={r.bytes_per_device:.4g} "
              f"(min {cost.bytes_min:.4g}) wire={ck} "
              f"terms: compute {r.compute_s:.4g}s memory {r.memory_s:.4g}s "
              f"collective {r.collective_s:.4g}s", flush=True)
    return out


def count_join_wave(index, xw: torch.Tensor, qids: torch.Tensor,
                    lane_valid: torch.Tensor, *, cell: JoinCell,
                    shard_size: int, theta: float = 1.0,
                    group=None) -> tuple[Cost, int]:
    """One rank's wave of ``cell`` on its shard's merged ``index``,
    counted under ``CostCounter`` → (its cost, the peak bytes held): the
    probe, one traversal iteration and the band compaction
    (``core.distributed.local_mi_iteration``), then, over ``group`` (the
    data axes; None: no combine), the pool combine, an all-gather of the
    (B, merge_cap) kept ids. Real tensors run it (the card's count of
    what the dry run predicts), fake ones trace it (``trace_join_wave``).
    Pass tensors that own their storage: the write-once bytes count each
    storage read."""
    import torch.distributed._functional_collectives as funcol

    from repro_torch.core.distributed import local_mi_iteration
    from repro_torch.core.types import TraversalConfig
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    cc = CostCounter()
    cc.track(index.vecs, index.nbrs, index.start, index.mean_nbr_dist, xw,
             qids, lane_valid)
    with cc:
        cand, _ = local_mi_iteration(
            index, xw, qids, lane_valid, theta=theta,
            cfg=TraversalConfig(pool_cap=cell.pool_cap,
                                max_iters=cell.max_iters),
            shard_size=shard_size, hybrid=cell.hybrid)
        if group is not None:
            funcol.wait_tensor(gather(cand, 0, group))
    return cc.snapshot(), cc.peak_bytes


def trace_join_wave(cell: JoinCell, *, n_shards: int, group=None,
                    device: str = "cuda") -> tuple[Cost, int]:
    """``count_join_wave`` on fake tensors of one of ``n_shards`` data
    shards (θ = 1.0, as the reference's): the shard's merged index
    (``n_data // n_shards`` data rows and the ``n_query`` query nodes, the
    vectors in the cell's dtype) and a wave of ``wave_size`` queries."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.types import GraphIndex
    rows, B = cell.n_data // n_shards, cell.wave_size
    n, vd = rows + cell.n_query, getattr(torch, cell.dtype)
    i32 = dict(dtype=torch.int32, device=device)
    with FakeTensorMode(allow_non_fake_inputs=True):
        index = GraphIndex(
            vecs=torch.empty((n, cell.dim), dtype=vd, device=device),
            nbrs=torch.empty((n, cell.degree), **i32),
            start=torch.zeros((), **i32),
            mean_nbr_dist=torch.empty((n,), device=device), n_data=rows)
        return count_join_wave(
            index, torch.empty((B, cell.dim), dtype=vd, device=device),
            torch.zeros((B,), **i32),
            torch.ones((B,), dtype=torch.bool, device=device), cell=cell,
            shard_size=rows, group=group)


def run_join_cell(name: str, *, mesh=None, multi_pod: bool = False,
                  device: str = "cuda", verbose: bool = True) -> dict:
    """A vector-join dry-run cell on the production mesh (opened and
    closed here unless ``mesh`` is given): X replicated, Y sharded over
    the data axes, ``mesh.size() // model`` shards → the roofline as a
    dict, with ``trace_s`` and ``expected_iters``."""
    cell = next(c for c in JOIN_DRYRUN_CELLS if c.name == name)
    own = mesh is None
    if own:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    try:
        mesh_name = "x".join(map(str, mesh.shape))
        n_dev = mesh.size()
        axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
        n_shards = n_dev // S.mesh_shape(mesh)["model"]
        sub = mesh[axes[0]] if len(axes) == 1 else mesh[axes]._flatten()
        t0 = time.time()
        cost, peak = trace_join_wave(cell, n_shards=n_shards,
                                     group=sub.get_group(), device=device)
        t_trace = time.time() - t0
    finally:
        if own:
            close_group()
    # the traversal loop exits data-dependently: its iteration (with the
    # probe and the compaction, as the reference's lowered step) scaled
    # by the expected iterations a wave; the combine runs once
    k = cell.expected_iters
    scaled = Cost(cost.flops * k, cost.bytes * k, cost.bytes_min * k,
                  cost.n_ops, cost.coll)
    r = analyze(arch=name, shape="join_wave", mesh_name=mesh_name,
                n_devices=n_dev, cost=scaled,
                model_flops=2.0 * cell.wave_size * cell.n_data * cell.dim,
                peak_memory=peak)
    out = r.as_dict()
    out.update(skipped=False, trace_s=round(t_trace, 1),
               expected_iters=k, local_ops=round(cost.n_ops))
    if verbose:
        print(f"[dryrun] join {name} on {mesh_name}: trace {t_trace:.0f}s, "
              f"{peak / 1e9:.4f} GB/dev of {r.hw.hbm_bytes / 1e9:.0f}, "
              f"bound={r.bottleneck}, step≈{r.step_s * 1e3:.4g} ms (min "
              f"{r.step_min_s * 1e3:.4g}), roofline "
              f"{100 * r.roofline_fraction:.3g}%", flush=True)
        ck = {k: v for k, v in sorted(r.collectives.items())}
        print(f"  cost: flops/dev={r.flops_per_device:.4g} "
              f"bytes/dev={r.bytes_per_device:.4g} "
              f"(min {scaled.bytes_min:.4g}) wire={ck} "
              f"terms: compute {r.compute_s:.4g}s memory {r.memory_s:.4g}s "
              f"collective {r.collective_s:.4g}s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--join", choices=[c.name for c in JOIN_DRYRUN_CELLS])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (no card needed)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not (args.join or args.all or (args.arch and args.shape)):
        ap.error("--arch/--shape, --join or --all required")
    # DTensor warns of every two-step all-reduce of a (pod,) data × model
    # partial sum
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    kw = dict(multi_pod=args.multi_pod, microbatches=args.microbatches,
              seq_parallel=args.seq_parallel, device=args.device)
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    results = []
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type=args.device)
    try:
        if args.join:
            cells = []
            results.append(run_join_cell(args.join, mesh=mesh,
                                         device=args.device))
        for arch, shape in cells:
            if not args.all:
                results.append(run_cell(arch, shape, mesh=mesh, **kw))
                continue
            try:
                results.append(run_cell(arch, shape, mesh=mesh, **kw))
            except Exception as e:  # noqa: BLE001 — sweep must finish
                print(f"[dryrun] FAILED {arch} × {shape}: {e!r}", flush=True)
                results.append(dict(arch=arch, shape=shape, error=repr(e)))
    finally:
        close_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    failed = [r for r in results if "error" in r]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
