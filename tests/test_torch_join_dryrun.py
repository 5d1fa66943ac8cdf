"""The port's vector-join dry run (``repro_torch.launch.dryrun --join``),
its separated traversal iteration, the 2-D-sharded exact NLJ count and the
ops the cost counter prices whole (#3's gather, the Mamba scan), against
the JAX package on the CPU.

The reference's ``analyze_hlo`` counts the FLOPs of dots only, and its
join step has none: it reads 0 FLOPs. The join's work is the gather
distance's difference form (subtract, square, reduce), which the port
prices as 3·B·K·d. So a shrunken cell's per-iteration FLOPs are held to
that term as the reference's compiled step computes it: the elements of
the subtract, multiply and reduce of every ``rowwise_sq_dists`` in the
HLO of its lowered ``make_distributed_mi_join`` step on a (2, 4) mesh (a
subprocess with 8 forced host devices), exactly. The rest (sorts,
scatters, compares) the reference prices as bytes only, and so does the
port; the two byte counts are printed, not held (two compilers chose
them).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.vectorjoin import JOIN_DRYRUN_CELLS as JCELLS
from repro_torch.configs.vectorjoin import JOIN_DRYRUN_CELLS, JoinCell
from repro_torch.core import distributed as D
from repro_torch.core import traversal
from repro_torch.core.types import TraversalConfig, graph_index_from_numpy
from repro_torch.engine import waves as W
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (close_group, make_local_mesh,
                                     make_production_mesh, open_fake_group)
from repro_torch.models import ssm
from repro_torch.roofline import cost as C

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# a shrunken join cell: 2 data shards of 1,024 rows, a wave of 16 queries
SHRUNK = dict(n_query=64, n_data=2048, dim=32, degree=8, wave_size=16,
              pool_cap=32)
VARIANTS = {"f32": dict(), "hybrid": dict(hybrid=True),
            "bf16": dict(dtype="bfloat16")}
NLJ_SHAPE = (300, 400, 24)         # queries (two waves), data rows, dims
NLJ_SEED = 7

_REF = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import compat
    from repro.core.distributed import (ShardedMergedIndex,
                                        make_distributed_mi_join,
                                        make_distributed_nlj_count)
    from repro.core.types import TraversalConfig
    from repro.roofline.hlo_cost import (_OPERAND_RE, _parse, _shape_dims,
                                         analyze_hlo)

    def distance_term(text):
        n = 0
        for comp in _parse(text).values():
            for ins in comp.instrs:
                if "jit(rowwise_sq_dists)/" not in ins.line:
                    continue
                if ins.op in ("subtract", "multiply"):
                    n += int(np.prod(_shape_dims(ins.shape)))
                elif ins.op == "reduce":
                    src = _OPERAND_RE.findall(ins.args)[0]
                    n += int(np.prod(_shape_dims(comp.shapes[src])))
        return n

    args = json.load(open(sys.argv[1]))
    auto = jax.sharding.AxisType.Auto
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto,) * 2)
    out = {}
    for name, c in args["cells"].items():
        S = 2
        rows = c["n_data"] // S
        m_total = rows + c["n_query"]
        vd = jnp.dtype(c["dtype"])
        sds = jax.ShapeDtypeStruct
        smi = ShardedMergedIndex(
            vecs=sds((S, m_total, c["dim"]), vd),
            nbrs=sds((S, m_total, c["degree"]), jnp.int32),
            start=sds((S,), jnp.int32),
            mean_nbr_dist=sds((S, m_total), jnp.float32),
            shard_size=rows, n_query=c["n_query"])
        tcfg = TraversalConfig(pool_cap=c["pool_cap"],
                               max_iters=c["max_iters"])
        step, qargs = make_distributed_mi_join(
            mesh, ("data",), smi, theta=1.0, cfg=tcfg, hybrid=c["hybrid"])
        B = c["wave_size"]
        text = step.lower(smi.vecs, smi.nbrs, smi.mean_nbr_dist, smi.start,
                          *qargs, sds((B, c["dim"]), vd),
                          sds((B,), jnp.int32),
                          sds((B,), jnp.bool_)).compile().as_text()
        hc = analyze_hlo(text)
        out[name] = dict(flops=hc.flops, bytes=hc.bytes,
                         bytes_min=hc.bytes_min, wire=hc.wire_bytes,
                         distance=distance_term(text))
    d = np.load(args["npz"])
    mesh3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                          axis_types=(auto,) * 3)
    nlj = make_distributed_nlj_count(mesh3, ("pod", "data"), "model",
                                     theta=float(d["theta"]))
    with compat.set_mesh(mesh3):
        out["nlj_count"] = np.asarray(
            nlj(jnp.asarray(d["X"]), jnp.asarray(d["Y"]))).tolist()
    json.dump(out, open(sys.argv[2], "w"))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(variant: str) -> JoinCell:
    return JoinCell(f"shrunk_{variant}", **SHRUNK, **VARIANTS[variant])


def _nlj_data():
    rng = np.random.default_rng(NLJ_SEED)
    B, N, d = NLJ_SHAPE
    X = rng.standard_normal((B, d)).astype(np.float32)
    Y = rng.standard_normal((N, d)).astype(np.float32)
    d2 = ((X[:, None, :].astype(np.float64) - Y[None]) ** 2).sum(-1)
    # θ at a gap of the distances, far from any pair (in float64)
    s = np.sort(np.sqrt(d2).ravel())
    i = len(s) // 50
    i += int(np.argmax(np.diff(s[i:i + 200])))
    theta = float((s[i] + s[i + 1]) / 2)
    return X, Y, theta, (np.sqrt(d2) < theta).sum(1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_join_dryrun")
    X, Y, theta, _ = _nlj_data()
    np.savez(tmp / "nlj.npz", X=X, Y=Y, theta=theta)
    cells = {v: dataclasses.asdict(_cell(v)) for v in VARIANTS}
    (tmp / "args.json").write_text(json.dumps(dict(cells=cells,
                                                   npz=str(tmp / "nlj.npz"))))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _REF, str(tmp / "args.json"),
                          str(tmp / "out.json")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture
def mesh24():
    open_fake_group(8)
    try:
        yield make_local_mesh(4, device_type="cpu")
    finally:
        close_group()


def test_join_cells_equal_reference():
    assert len(JOIN_DRYRUN_CELLS) == len(JCELLS) == 5
    for got, want in zip(JOIN_DRYRUN_CELLS, JCELLS):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(JoinCell)] == \
        [f.name for f in dataclasses.fields(type(JCELLS[0]))]
    assert all(c.max_iters == 64 and c.expected_iters == 32
               for c in JOIN_DRYRUN_CELLS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_iteration_flops_match_reference(variant, reference, mesh24):
    """One rank's traced iteration on a (2, 4) mesh: its FLOPs are the
    reference HLO's distance term exactly (the probe's B·R and one
    expansion's B·E·R gathered rows), 3·B·d·(R + E·R); the reference's
    ``analyze_hlo`` FLOPs are 0 (dots only). The combine is one all-gather
    of the (B, merge_cap) ids over the 2 data ranks."""
    cell = _cell(variant)
    cost, peak = dryrun.trace_join_wave(
        cell, n_shards=2, group=mesh24.get_group("data"), device="cpu")
    want = reference[variant]
    E = TraversalConfig().expand_per_iter
    B, d, R = cell.wave_size, cell.dim, cell.degree
    print(f"{variant}: flops port {cost.flops} reference distance term "
          f"{want['distance']} (analyze_hlo {want['flops']}); bytes "
          f"{cost.bytes} / {want['bytes']}; bytes_min {cost.bytes_min} / "
          f"{want['bytes_min']}; wire {want['wire']}; peak {peak}")
    assert want["flops"] == 0.0
    assert cost.flops == want["distance"] == 3 * B * d * (R + E * R)
    (rec, n), = cost.coll.items()
    assert (rec.kind, rec.group, n) == ("all-gather", 2, 1)
    assert rec.size == 2 * B * D.DEFAULT_MERGE_CAP * 4


def test_join_cell_scales_one_iteration():
    """``run_join_cell`` scales the iteration's FLOPs and bytes by the
    expected iterations and counts the combine once (full-width cell on
    the (32, 8) mesh; it closes the fake group it opened)."""
    cell = JOIN_DRYRUN_CELLS[0]
    out = dryrun.run_join_cell(cell.name, device="cpu", verbose=False)
    assert not torch.distributed.is_initialized()
    mesh = make_production_mesh(device_type="cpu")
    try:
        cost, _ = dryrun.trace_join_wave(cell, n_shards=32, device="cpu",
                                         group=mesh.get_group("data"))
    finally:
        close_group()
    assert out["mesh"] == "32x8" and out["n_devices"] == 256
    assert out["flops_per_device"] == cost.flops * cell.expected_iters
    assert out["bytes_per_device"] == cost.bytes * cell.expected_iters
    assert out["wire_bytes_per_device"] == pytest.approx(
        32 * cell.wave_size * D.DEFAULT_MERGE_CAP * 4 * 31 / 32)
    assert out["model_flops"] == 2.0 * cell.wave_size * cell.n_data * cell.dim


def _small_smi(n_shards: int, dtype=torch.float32):
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((400, 16)).astype(np.float32)
    X = rng.standard_normal((24, 16)).astype(np.float32)
    smi = D.build_sharded_merged_index(torch.from_numpy(Y),
                                       torch.from_numpy(X), n_shards,
                                       k=12, degree=8)
    if dtype != torch.float32:
        smi = dataclasses.replace(smi, shards=tuple(
            dataclasses.replace(g, vecs=g.vecs.to(dtype))
            for g in smi.shards))
    return smi, torch.from_numpy(X[:16].copy()).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hybrid", [False, True])
def test_fake_trace_equals_real_cpu_trace(hybrid, dtype, mesh24):
    """One shard's wave counted on its real CPU tensors
    (``count_join_wave``) and traced from the cell's shapes alone
    (``trace_join_wave``, what the dry run's rows come from): every field
    of the cost and the peak equal, FLOPs the gathers' rule; the mesh
    iteration over both shards counts twice the traced FLOPs."""
    smi, X = _small_smi(2, dtype)
    g = smi.shards[0]
    B = X.shape[0]
    cell = JoinCell("small", n_query=smi.n_query, n_data=2 * smi.shard_size,
                    dim=X.shape[1], degree=g.degree, wave_size=B,
                    pool_cap=32, hybrid=hybrid,
                    dtype=str(dtype).removeprefix("torch."))
    qids = torch.arange(B, dtype=torch.int32)
    lv = torch.ones(B, dtype=torch.bool)
    group = mesh24.get_group("data")
    real = dryrun.count_join_wave(g, X, qids, lv, cell=cell,
                                  shard_size=smi.shard_size, theta=1.5,
                                  group=group)
    fake = dryrun.trace_join_wave(cell, n_shards=2, group=group,
                                  device="cpu")
    assert real == fake
    E, R, d = TraversalConfig().expand_per_iter, g.degree, X.shape[1]
    assert real[0].flops == 3 * B * d * (R + E * R)
    assert len(real[0].coll) == 1
    mesh = C.CostCounter()
    with mesh:
        D.mesh_mi_iteration(smi, X, qids, lv, theta=1.5,
                            cfg=TraversalConfig(pool_cap=32), hybrid=hybrid)
    assert mesh.flops == 2 * fake[0].flops


@pytest.mark.parametrize("hybrid", [False, True])
def test_expand_step_loop_equals_range_expand(hybrid, ds_manifold,
                                              index_merged):
    """``expand_init`` and ``expand_step`` stepped by a host loop that
    tests ``done`` as ``range_expand`` does: every output and counter bit
    for bit ``range_expand``'s, on the reference's merged index."""
    idx = graph_index_from_numpy(
        np.asarray(index_merged.vecs), np.asarray(index_merged.nbrs),
        np.asarray(index_merged.start), np.asarray(index_merged.mean_nbr_dist),
        index_merged.n_data, CPU)
    theta = float(np.quantile(np.linalg.norm(
        ds_manifold.X[:8, None] - ds_manifold.Y[None], axis=-1), 0.02))
    cfg = TraversalConfig(pool_cap=64, max_iters=1024)
    B = 24
    xw = torch.from_numpy(ds_manifold.X[:B])
    lv = torch.ones(B, dtype=torch.bool)
    qids = torch.arange(B, dtype=torch.int32) + idx.n_data

    def probe():
        rows, dist, ub, valid, visited, n_new, n_esc, best, besti = \
            W._mi_probe(idx, xw, qids, lv, traverse_nondata=hybrid,
                        dist_impl=None)
        return dict(init_idx=rows, init_dist=dist, init_valid=valid,
                    visited=visited, best_dist=best, best_idx=besti,
                    n_dist=n_new, init_ub=ub, n_esc=n_esc)

    kw = dict(cfg=cfg, n_data=idx.n_data, hybrid=hybrid)
    want = traversal.range_expand(idx, xw, theta, traverse_nondata=hybrid,
                                  **kw, **probe())
    st = traversal.expand_init(xw, theta, **kw, **probe())
    n = 0
    while n < cfg.max_iters and not bool(st.done.all()):
        st = traversal.expand_step(st, idx, xw, theta,
                                   traverse_nondata=hybrid, **kw)
        n += 1
    got = traversal.expand_result(st, cfg.pool_cap, n)
    assert got.n_iters == want.n_iters > 1
    for f in traversal.ExpandResult._fields:
        if f != "n_iters":
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(want.n_pool.sum()) > 0


def test_nlj_count_2d_matches_reference_and_brute_force(reference):
    """On a (2, 2, 2) logical mesh of the CPU: rows over (pod, data),
    dimensions over model; the queries in two waves."""
    X, Y, theta, brute = _nlj_data()
    assert D.NLJ_COUNT_WAVE < X.shape[0] <= 2 * D.NLJ_COUNT_WAVE
    mesh = D.DeviceMesh.on_device("cpu", 8, (2, 2, 2),
                                  ("pod", "data", "model"))
    count = D.make_distributed_nlj_count(mesh, ("pod", "data"), "model",
                                         theta=theta)
    got = count(torch.from_numpy(X), torch.from_numpy(Y))
    assert got.dtype == torch.int32 and got.shape == (X.shape[0],)
    assert got.tolist() == reference["nlj_count"] == brute.tolist()
    assert 0 < int(got.sum()) < X.shape[0] * Y.shape[0]
    # ragged: rows and dims that do not divide the mesh
    got = D.make_distributed_nlj_count(mesh, ("pod", "data"), "model",
                                       theta=theta)(
        torch.from_numpy(X[:, :23]), torch.from_numpy(Y[:399, :23]))
    dist = np.sqrt(((X[:, None, :23].astype(np.float64)
                     - Y[None, :399, :23]) ** 2).sum(-1))
    want = (dist < theta).sum(1)
    # pairs within 1e-5 of θ may round to either side in f32
    band = (np.abs(dist - theta) <= 1e-5 * theta).sum(1)
    assert (np.abs(got.numpy() - want) <= band).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_op_is_the_plain_version_priced_by_rule(dtype):
    """``repro_torch::gather_sq_dists`` on the CPU is ``ref.gather_sq_dists``
    (bf16 rows and queries summed in f32, as the reference upcasts); the
    counter prices it 3·B·K·d FLOPs and its bytes once each. The counter
    counts products only, so the plain version run op by op reads 0
    FLOPs; its subtract, square and reduce hold 3·B·K·d elements, which is
    the rule."""
    g = torch.Generator().manual_seed(0)
    B, K, d, N = 5, 7, 12, 30
    v = torch.randn(N, d, generator=g).to(dtype)
    x = torch.randn(B, d, generator=g).to(dtype)
    idx = torch.randint(-1, N, (B, K), generator=g, dtype=torch.int32)
    want = ref.gather_sq_dists(v, x, idx)
    assert torch.equal(torch.ops.repro_torch.gather_sq_dists(v, x, idx), want)
    cc = C.CostCounter()
    with cc:
        got = ops.gather_sq_dists(v, x, idx)
    assert torch.equal(got, want)
    assert dict(cc.op_counts) == {
        torch.ops.repro_torch.gather_sq_dists.default: 1}
    its = v.element_size()
    assert cc.flops == 3 * B * K * d
    assert cc.bytes == cc.bytes_min == B * K * d * its + B * d * its \
        + 8 * B * K

    elems = []

    class Elementwise(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.ops.aten.sub.Tensor, torch.ops.aten.mul.Tensor):
                elems.append(out.numel())
            elif func is torch.ops.aten.sum.dim_IntList:
                elems.append(args[0].numel())
            return out

    plain = C.CostCounter()
    with plain:
        ref.gather_sq_dists(v, x, idx)
    with Elementwise():
        ref.gather_sq_dists(v, x, idx)
    assert plain.flops == 0
    assert sum(elems) == 3 * B * K * d
    # fake tensors go through the op's shape (no kernel, no data)
    with FakeTensorMode():
        f = ops.gather_sq_dists(torch.empty(N, d, dtype=dtype),
                                torch.empty(B, d, dtype=dtype),
                                torch.empty(B, K, dtype=torch.int32))
    assert f.shape == (B, K) and f.dtype == torch.float32


# #3's bf16 entry held to the JAX package's gather on bf16 rows: the
# inputs (bf16 bit patterns, NO_NODE ids included) and the reference's
# output, kept so that the card's test compares with the same output
# without JAX. ``python tests/test_torch_join_dryrun.py`` rewrites it.
BF16_GATHER_REFERENCE = ROOT / "tests" / "data" / "gather_bf16_reference.npz"
BF16_GATHER_CASES = ((97, 136, 24, 40), (61, 33, 9, 17), (24, 2048, 3, 12))


def _jax_bf16_gather(vbits, xbits, idx):
    """``repro.kernels.ops.gather_sq_dists(..., impl="ref")`` on the bf16
    arrays with these bit patterns."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    bf = lambda b: jax.lax.bitcast_convert_type(jnp.asarray(b),
                                                jnp.bfloat16)
    return np.asarray(jops.gather_sq_dists(bf(vbits), bf(xbits),
                                           jnp.asarray(idx), impl="ref"))


def write_bf16_gather_reference(path=BF16_GATHER_REFERENCE) -> None:
    out = {}
    for i, (N, d, B, K) in enumerate(BF16_GATHER_CASES):
        rng = np.random.default_rng(N * d)
        bits = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).bfloat16().view(torch.int16).numpy()
        out[f"vecs{i}"], out[f"x{i}"] = bits(N, d), bits(B, d)
        out[f"idx{i}"] = rng.integers(-1, N, (B, K)).astype(np.int32)
        out[f"want{i}"] = _jax_bf16_gather(out[f"vecs{i}"], out[f"x{i}"],
                                           out[f"idx{i}"])
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)


def _close_rows(got, want):
    """The gather's tolerance (the card's tests'): +inf where the
    reference has it, the rest within 1e-6·value + 1e-6·max (the two sum
    d f32 squares in different orders)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    g, w = got[fin], want[fin]
    assert (np.abs(g - w) <= 1e-6 * np.abs(w) + 1e-6 * np.abs(w).max()).all()


@pytest.mark.parametrize("case", range(len(BF16_GATHER_CASES)))
def test_gather_bf16_matches_jax_reference(case):
    """``ops.gather_sq_dists`` and ``repro_torch::gather_sq_dists`` on bf16
    rows and queries (the ``join_lm_embed_bf16`` cell's gather, ids with
    NO_NODE) against the JAX package's ``gather_sq_dists`` (it upcasts to
    f32) on the same bf16 arrays, within the gather's tolerance; the kept
    reference output is the JAX package's today, bit for bit."""
    ref_file = np.load(BF16_GATHER_REFERENCE)
    vbits, xbits, idx, kept = (ref_file[f"{k}{case}"]
                               for k in ("vecs", "x", "idx", "want"))
    assert (-1 == idx).any() and vbits.shape[1] == \
        BF16_GATHER_CASES[case][1]
    want = _jax_bf16_gather(vbits, xbits, idx)
    assert np.array_equal(want, kept)
    v = torch.from_numpy(vbits).view(torch.bfloat16)
    x = torch.from_numpy(xbits).view(torch.bfloat16)
    i = torch.from_numpy(idx)
    got = ops.gather_sq_dists(v, x, i)
    assert got.dtype == torch.float32 and got.shape == idx.shape
    _close_rows(got.numpy(), want)
    assert torch.equal(torch.ops.repro_torch.gather_sq_dists(v, x, i), got)
    with C.CostCounter():
        assert torch.equal(ops.gather_sq_dists(v, x, i), got)


def test_gather_op_route_keeps_impl():
    """Under a dispatch mode the wrapper holds ``impl`` to the tensor's
    own route, as it does outside one: the CPU's plain version, and
    ``impl="cuda"`` on CPU tensors raises either way."""
    v, x = torch.zeros(4, 3), torch.zeros(2, 3)
    i = torch.zeros(2, 2, dtype=torch.int32)
    for mode in (None, C.CostCounter()):
        with mode or contextlib.nullcontext():
            assert torch.equal(ops.gather_sq_dists(v, x, i, impl="ref"),
                               torch.zeros(2, 2))
            with pytest.raises(ValueError, match="impl='cuda'"):
                ops.gather_sq_dists(v, x, i, impl="cuda")


def _scan_inputs(S: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    B, di, n = 2, 6, 4
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return [t(B, di, n), torch.from_numpy(
        rng.uniform(0.01, 0.2, (B, S, di)).astype(np.float32)), t(B, S, n),
        t(B, S, n), t(B, S, di), -torch.from_numpy(
            rng.uniform(0.5, 2.0, (di, n)).astype(np.float32))]


def test_mamba_scan_op_equals_the_loop():
    """The op's outputs and grads (every input, and only some of them,
    with one output unused) are the loop's bit for bit."""
    gy = _scan_inputs(8, 1)[4]
    for needs in ([True] * 6, [False, True, False, True, True, False]):
        for use_h in (False, True):
            grads = []
            for fn in (ssm._mamba_inner_scan, ssm.mamba_scan):
                ins = [a.clone().requires_grad_(n)
                       for a, n in zip(_scan_inputs(8), needs)]
                h, y = fn(*ins)
                grads.append(((h, y), torch.autograd.grad(
                    (y * gy).sum() + (h.sum() if use_h else 0),
                    [a for a in ins if a.requires_grad])))
            (o1, g1), (o2, g2) = grads
            assert all(torch.equal(a, b) for a, b in zip(o1, o2))
            assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("backward", [False, True])
def test_mamba_scan_priced_as_its_loop(backward):
    """At S = 8 the counter's price of the op (its loop counted at 1 and
    2 tokens, the rest exact repeats) equals the loop counted whole: FLOPs,
    bytes, write-once bytes and ops. The op dispatches once."""
    args = _scan_inputs(8)
    if backward:
        gy = _scan_inputs(8, 1)[4]
        needs = [False, True, True, True, True, True]
        fn = lambda: ssm.mamba_scan_grads(*args, None, gy, needs)
        op = lambda: ssm.mamba_scan_backward(*args, None, gy, needs)
    else:
        fn = lambda: ssm._mamba_inner_scan(*args)
        op = lambda: ssm.mamba_scan(*args)
    whole, priced = C.CostCounter(), C.CostCounter()
    with whole:
        fn()
    with priced:
        op()
    assert priced.n_dispatched == 1 and whole.n_dispatched > 8
    assert priced.cost == whole.cost
    assert whole.flops > 0


if __name__ == "__main__":
    write_bf16_gather_reference()
