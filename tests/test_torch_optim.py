"""The port's optimizers, schedule and gradient compression against the
JAX package, on the CPU.

Both optimizers get **identical grads** (numpy, from a seed) each step, so
what is compared is the update's own arithmetic, not a last-bit
difference of two backward passes that AdamW's first, sign-like steps
would blow up to 2·lr. The reference runs op by op (eager), as the port
does. Tolerances, leaf by leaf: f32 states and parameters within rtol
1e-6 plus 1e-7 × the leaf's largest value (a few f32 ulps: the two
libraries' pow, sqrt and division may round apart, and ``p − lr·(upd +
wd·p)`` cancels near 0); bf16 moments and parameters within one bf16 ulp
(rtol 2^-7), where an f32 sum one ulp apart may round to the
neighbouring bf16; the schedule within rtol 1e-6 (numpy's and XLA's
f32 cos and division round apart); the Adafactor stack within rtol 1e-5
plus 1e-6 × the leaf's largest value (its RMS is summed layer by layer,
the reference's over the stacked leaf). Compression is bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lm_ref import _f32_params, configs
from repro.core.compat import P, shard_map
from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim.adamw import clip_by_global_norm as jax_clip
from repro.optim.compress import _dequantize as jax_dequantize
from repro.optim.compress import _quantize as jax_quantize
from repro.optim.compress import ef_quantized_psum as jax_ef_psum
from repro_torch.core.distributed import DeviceMesh
from repro_torch.models import model as M
from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                               warmup_cosine)
from repro_torch.optim.compress import (_dequantize, _quantize,
                                        ef_quantized_psum, flatten_grads,
                                        make_compressed_allreduce,
                                        unflatten_grads)

F32 = dict(rtol=1e-6, atol_of_max=1e-7)
BF16 = dict(rtol=2.0**-7, atol_of_max=1e-9)
STACK = dict(rtol=1e-5, atol_of_max=1e-6)
SHAPES = {"big": (130, 140), "wide": (3, 128, 129), "vec": (64,),
          "small": (5, 7), "scalar": ()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _f32_params.cache_clear()


def _np(a) -> np.ndarray:
    """A tensor or JAX array as f32 numpy (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _trees(rng, dtype="float32"):
    """The same parameters for both packages: (reference dict, port dict)."""
    ref, port = {}, {}
    for k, shape in SHAPES.items():
        a = np.asarray(rng.normal(size=shape), np.float32)
        ref[k] = jnp.asarray(a, dtype)
        port[k] = torch.from_numpy(a).to(getattr(torch, dtype))
    return ref, port


def _grads(rng, step: int):
    """Identical f32 grads; some entries tiny, some zero."""
    out = {}
    for k, shape in SHAPES.items():
        g = np.asarray(rng.normal(size=shape) * 10.0 ** (step % 3 - 1),
                       np.float32)
        if g.size > 4:
            g.reshape(-1)[::7] *= 1e-6
            g.reshape(-1)[::11] = 0
        out[k] = g
    return out


def _run(jopt, topt, rng, steps=5, dtype="float32", lr=1e-2):
    jp, tp = _trees(rng, dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _grads(rng, i)
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, jnp.float32(lr))
        topt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                    ts, tp, lr)
    return jp, js, tp, ts


def _close_trees(got, want, tol):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert tuple(g.shape) == tuple(w.shape), jax.tree_util.keystr(path)
        w = _np(w)
        atol = tol["atol_of_max"] * float(np.abs(w).max(initial=0))
        np.testing.assert_allclose(_np(g), w, rtol=tol["rtol"], atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("peak,warm,total,end", [(3e-3, 5, 100, 0.1),
                                                 (2e-4, 2, 8, 0.1),
                                                 (1.0, 0, 10, 0.0),
                                                 (1e-3, 40, 30, 0.5)])
def test_warmup_cosine_matches_reference(peak, warm, total, end):
    jlr = jax_warmup_cosine(peak_lr=peak, warmup_steps=warm,
                            total_steps=total, end_lr_frac=end)
    tlr = warmup_cosine(peak_lr=peak, warmup_steps=warm, total_steps=total,
                        end_lr_frac=end)
    steps = np.arange(total + 5)
    got = np.array([tlr(int(s)) for s in steps])
    want = np.array([float(jlr(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert tlr(0) == (0.0 if warm > 0 else want[0])
    assert all(isinstance(tlr(int(s)), float) for s in steps[:3])


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_f32_matches_reference(wd):
    jp, js, tp, ts = _run(jax_adamw(weight_decay=wd), adamw(weight_decay=wd),
                          np.random.default_rng(1))
    _close_trees(tp, jp, F32)
    _close_trees(ts["mu"], js["mu"], F32)
    _close_trees(ts["nu"], js["nu"], F32)
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32


def test_adamw_bf16_moments_and_params_match_reference():
    """bf16 parameters and moments: the f32 update rounded once to each."""
    jp, js, tp, ts = _run(jax_adamw(moment_dtype=jnp.bfloat16),
                          adamw(moment_dtype=torch.bfloat16),
                          np.random.default_rng(2), dtype="bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in ts["mu"].values())
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    _close_trees(tp, jp, BF16)
    _close_trees(ts["mu"], js["mu"], BF16)
    _close_trees(ts["nu"], js["nu"], BF16)


def test_adamw_without_clip_matches_reference():
    jp, js, tp, ts = _run(jax_adamw(grad_clip=None), adamw(grad_clip=None),
                          np.random.default_rng(3))
    _close_trees(tp, jp, F32)
    _close_trees(ts["nu"], js["nu"], F32)


@pytest.mark.parametrize("min_dim", [128, 4])
def test_adafactor_matches_reference(min_dim):
    """``big`` and ``wide`` are factored (last two axes ≥ 128), the rest
    keep a full v; with min_dim 4 ``small`` is factored too."""
    jp, js, tp, ts = _run(jax_adafactor(min_dim_size_to_factor=min_dim,
                                        weight_decay=0.01),
                          adafactor(stack_of=None,
                                    min_dim_size_to_factor=min_dim,
                                    weight_decay=0.01),
                          np.random.default_rng(4))
    assert set(ts["v"]["big"]) == {"r", "c"} and set(ts["v"]["vec"]) == {"v"}
    assert (set(ts["v"]["small"]) == {"r", "c"}) == (min_dim == 4)
    _close_trees(tp, jp, F32)
    _close_trees(ts["v"], js["v"], F32)


def test_adafactor_clips_by_the_rms_of_the_reference_stack():
    """The port's unstacked layers against the reference's stacked (G, ...)
    leaves (gemma2's smoke config: a period of 2, G = 2), factoring at 32:
    with ``stack_of=stacked_name`` the update's RMS clip spans a stack,
    as the reference's spans its leaf."""
    jc, pc = configs("gemma2_9b", "f32")
    tree = jax.tree.map(np.asarray, _f32_params("gemma2_9b"))
    model = M.params_from_numpy(pc, tree, "cpu")
    tp = dict(model.named_parameters())
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = jax_adafactor(min_dim_size_to_factor=32)
    topt = adafactor(min_dim_size_to_factor=32,
                     stack_of=functools.partial(M.stacked_name, pc))
    js, ts = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(5)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (i + 1) ** 2
                                    ).astype(np.float32), tree)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             jnp.float32(0.05))
        gt = dict(M.params_from_numpy(pc, g, "cpu").named_parameters())
        topt.update({k: v.detach().clone() for k, v in gt.items()}, ts, tp,
                    0.05)
    back = M.params_to_numpy(pc, {k: v.detach() for k, v in tp.items()})
    _close_trees(jax.tree.map(torch.from_numpy, back), jp, STACK)
    # without it each layer is clipped alone, and some parameter differs
    topt2 = adafactor(stack_of=None, min_dim_size_to_factor=32)
    tp2 = dict(M.params_from_numpy(pc, tree, "cpu").named_parameters())
    ts2 = topt2.init(tp2)
    rng = np.random.default_rng(5)
    g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     tree)
    gt = dict(M.params_from_numpy(pc, g, "cpu").named_parameters())
    topt2.update({k: v.detach().clone() for k, v in gt.items()}, ts2, tp2,
                 0.05)
    jp2, _ = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(
        jax.tree.map(jnp.asarray, tree)), jax.tree.map(jnp.asarray, tree),
        jnp.float32(0.05))
    back2 = M.params_to_numpy(pc, {k: v.detach() for k, v in tp2.items()})
    assert any(not np.allclose(a, np.asarray(b), rtol=1e-4) for a, b in zip(
        jax.tree.leaves(back2), jax.tree.leaves(jp2)))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(6)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    want = jax_clip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got = clip_by_global_norm({k: torch.from_numpy(v.copy())
                               for k, v in g.items()}, max_norm)
    _close_trees(got, want, F32)


# -- the reference's own optimizer cases, on the port ------------------------

def _quadratic_params():
    return dict(w=torch.linspace(-2, 2, 64), b=torch.zeros(8))


def _loss(p):
    return (p["w"] ** 2).sum() + ((p["b"] - 1.0) ** 2).sum()


@pytest.mark.parametrize("make_opt", [
    lambda: adamw(weight_decay=0.0),
    lambda: adamw(weight_decay=0.0, moment_dtype=torch.bfloat16),
    lambda: adafactor(stack_of=None),
])
def test_optimizer_descends(make_opt):
    opt = make_opt()
    params = _quadratic_params()
    state = opt.init(params)
    losses = []
    for _ in range(60):
        g = {k: 2 * (v - (1.0 if k == "b" else 0.0)) for k, v in
             params.items()}
        opt.update(g, state, params, 0.05)
        losses.append(float(_loss(params)))
    assert losses[-1] < 0.05 * losses[0]


def test_adafactor_factored_shapes():
    opt = adafactor(stack_of=None, min_dim_size_to_factor=4)
    st = opt.init(dict(big=torch.zeros(16, 8), small=torch.zeros(3)))
    assert st["v"]["big"]["r"].shape == (16,)
    assert st["v"]["big"]["c"].shape == (8,)
    assert st["v"]["small"]["v"].shape == (3,)


def test_grad_clip_bounds_the_update():
    opt = adamw(grad_clip=1.0, weight_decay=0.0)
    params = dict(w=torch.zeros(4))
    opt.update(dict(w=torch.full((4,), 1e6)), opt.init(params), params, 1.0)
    assert float(params["w"].abs().max()) < 10.0


# -- compression ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
def test_quantize_bit_for_bit(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 3, n)).astype(
        np.float32)
    if n >= 512:
        x[256:512] = 0                                   # an all-zero block
    q, s = _quantize(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_dequantize(q, s, n).numpy(),
                                  np.asarray(jax_dequantize(jq, js, n)))


def test_quantize_rounds_half_to_even():
    """A block whose max is 127: the scale is 1 and x.5 rounds to even."""
    x = np.zeros(256, np.float32)
    x[:6] = [127, 0.5, 1.5, 2.5, -0.5, -3.5]
    q, s = _quantize(torch.from_numpy(x))
    assert float(s[0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -4]
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jax_quantize(jnp.asarray(x))[0]))


def test_flatten_unflatten_grads():
    tree = dict(a=torch.ones(3, 4, dtype=torch.bfloat16),
                b=torch.arange(5, dtype=torch.float32))
    flat, meta = flatten_grads(tree)
    assert flat.dtype == torch.float32 and flat.shape == (17,)
    back = unflatten_grads(flat, meta)
    assert back["a"].dtype == torch.bfloat16 and back["a"].shape == (3, 4)
    assert list(back) == ["a", "b"]
    assert torch.equal(back["b"], tree["b"])


def test_ef_psum_one_shard_matches_reference():
    """The reference's single-device case over two steps, bit for bit
    against its body run op by op (``disable_jit``; compiled, XLA divides
    the scale by 127 another way, one f32 ulp apart): the residual carries
    what quantization lost, so the two-step sum is exact to one
    quantization step."""
    mesh = jax.make_mesh((1,), ("data",))
    fn = shard_map(functools.partial(jax_ef_psum, axes=("data",)),
                   mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
                   check_vma=False)
    tfn = make_compressed_allreduce(DeviceMesh.on_device("cpu", 1), "data",
                                    1024)
    g = np.random.default_rng(1).normal(0, 1, 1024).astype(np.float32)
    jerr, terr = jnp.zeros(1024), torch.zeros(1024)
    total = np.zeros(1024, np.float32)
    for _ in range(2):
        with jax.disable_jit():
            jr, jerr = fn(jnp.asarray(g), jerr)
        tr, terr = tfn(torch.from_numpy(g), terr)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))
        total += tr.numpy()
    np.testing.assert_allclose(total, 2 * g, atol=2e-2)
    assert float(terr.abs().max()) < 0.05


def test_ef_psum_two_shards_is_the_reference_composition():
    """Two shards with different grads: each shard's residual and the
    shared result are the reference's own quantize/dequantize composed as
    its ``ef_quantized_psum`` does (int8 summed in int32, mean scale)."""
    rng = np.random.default_rng(2)
    n = 700
    gs = [rng.normal(size=n).astype(np.float32) for _ in range(2)]
    es = [rng.normal(size=n).astype(np.float32) * 1e-3 for _ in range(2)]
    red, new = ef_quantized_psum([torch.from_numpy(g) for g in gs],
                                 [torch.from_numpy(e) for e in es])
    qs, ss = [], []
    for g, e, ne in zip(gs, es, new):
        target = jnp.asarray(g) / 2 + jnp.asarray(e)
        q, s = jax_quantize(target)
        np.testing.assert_array_equal(
            ne.numpy(), np.asarray(target - jax_dequantize(q, s, n)))
        qs.append(q.astype(jnp.int32))
        ss.append(s)
    want = jax_dequantize(qs[0] + qs[1], (ss[0] + ss[1]) / 2, n)
    for r in red:
        np.testing.assert_array_equal(r.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="flat"):
        make_compressed_allreduce(DeviceMesh.on_device("cpu", 2), "data",
                                  n)(torch.zeros(3), torch.zeros(3))
