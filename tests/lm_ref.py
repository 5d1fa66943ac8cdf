"""The JAX reference's side of the LM parity tests
(``tests/test_torch_lm*.py``, ``tests/test_torch_train_grads*.py``): for
an arch's smoke config in f32 or bf16, the reference's weights, inputs
made from a seed, and every output the tests compare, and the checks that
hold the port to them. For training: the reference's ``loss_fn`` and its
``jax.grad`` at a remat schedule, and the port's grads carried back into
the reference's layout (``models.model.params_to_numpy``).

The reference runs compiled with XLA's excess precision off
(``compiled``): on, XLA may keep a fused bf16 intermediate in f32 that the
reference's code rounds to bf16, so its own compiled bf16 drifts a few
bf16 ulps from its op-by-op semantics, which the port follows.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get as jax_get
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, get
from repro_torch.models import model as M

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, S = 2, 12               # forward
PROMPTS = (7, 20)          # ragged lanes; 20 tokens pass a window of 16
SMAX, STEPS = 32, 4
DECODABLE = [a for a in ARCH_IDS if not get(a).smoke.encoder_only]


def configs(arch: str, dtype: str):
    """(JAX config, port config) of the arch's smoke model in ``dtype``."""
    jc, pc = jax_get(arch).smoke, get(arch).smoke
    if dtype == "f32":
        jc = jc.with_overrides(dtype=jnp.float32)
        pc = pc.with_overrides(dtype=torch.float32)
    return jc, pc


def positions(mc, b: int, s: int, start=0) -> np.ndarray:
    """(b, s) positions, or (b, s, 3) M-RoPE streams that differ (t, t//2,
    t%3), so each section turns by its own stream."""
    t = np.broadcast_to(np.arange(s, dtype=np.int32) + np.asarray(
        start, np.int32).reshape(-1, 1), (b, s))
    if mc.pos_dims == 3:
        return np.stack([t, t // 2, t % 3], -1).astype(np.int32)
    return np.ascontiguousarray(t)


def inputs(mc, rng, b: int, s: int) -> np.ndarray:
    if mc.input_kind == "embeddings":
        return rng.normal(size=(b, s, mc.frontend_dim)).astype(np.float32)
    return rng.integers(0, mc.vocab, (b, s)).astype(np.int32)


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _set_lane(caches, lane, one):
    """The engine's refill: lane ``lane`` of every cache leaf ← a B=1 cache."""
    if isinstance(caches, tuple):                   # the reference's
        return jax.tree.map(lambda c, c1: c.at[:, lane].set(
            c1[:, 0].astype(c.dtype)), caches, one)
    for c, c1 in zip(caches, one):
        for k in c:
            c[k][lane] = c1[k][0].to(c[k].dtype)
    return caches


def cache_leaves(mc, jcaches):
    """The reference's (G, ...)-stacked caches as per-layer dicts."""
    P = len(mc.period)
    return [{k: np.asarray(v)[i // P] for k, v in jcaches[i % P].items()}
            for i in range(mc.n_layers)]


def compiled(fn, *args):
    """``fn`` compiled for ``args``' shapes with XLA's excess precision off:
    with it on, XLA may keep a fused bf16 intermediate in f32 that the
    reference's code rounds to bf16 (op by op, the port gives the same
    bits), and the reference's own bf16 then drifts by a few bf16 ulps."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


@functools.cache
def _f32_params(arch: str):
    return JM.init_params(jax.random.key(3), configs(arch, "f32")[0])


def jax_params(arch: str, dtype: str):
    """The reference's init of the arch's smoke model in ``dtype``. Its
    init draws every leaf in f32 and casts it to the leaf's dtype, so the
    bf16 tree is the f32 one cast leaf by leaf (one init an arch)."""
    f32 = _f32_params(arch)
    if dtype == "f32":
        return f32
    shapes = jax.eval_shape(functools.partial(
        JM.init_params, cfg=configs(arch, dtype)[0]), jax.random.key(3))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), f32, shapes)


def run_reference(arch: str, dtype: str) -> dict:
    """Every output the tests compare, from the JAX package, and the
    inputs and weights that produced them."""
    jc, pc = configs(arch, dtype)
    rng = np.random.default_rng(zlib.crc32(f"{arch}/{dtype}".encode()))
    params = jax_params(arch, dtype)
    out = dict(tree=jax.tree.map(np.asarray, params), pc=pc)
    x = inputs(jc, rng, B, S)
    p = positions(jc, B, S)
    out.update(x=x, p=p)

    moe = any(bc.moe is not None for bc in jc.period)

    def full(x, p):
        h = JM.forward(params, jc, x, p)[0]
        hx = JM.forward(params, jc, x, p, exact_moe=True)[0] if moe else h
        return h, JM.logits_fn(params, jc, h), hx

    out["h"], out["logits"], out["h_exact"] = map(
        np.asarray, compiled(full, x, p)(x, p))
    if jc.encoder_only:
        return out
    prompts = [inputs(jc, rng, 1, n) for n in PROMPTS]
    caches = JM.init_caches(jc, len(PROMPTS), SMAX)
    out["prompts"], out["prefill"] = prompts, []
    for lane, pr in enumerate(prompts):
        pp = positions(jc, 1, len(pr[0]))
        lg, one = compiled(lambda x, p: JM.prefill(params, jc, x, p, SMAX),
                           pr, pp)(pr, pp)
        out["prefill"].append((np.asarray(lg), cache_leaves(jc, one)))
        caches = _set_lane(caches, lane, one)
    toks = rng.integers(0, jc.vocab, (STEPS, len(PROMPTS), 1)).astype(
        np.int32)
    lens = np.array(PROMPTS, np.int32)
    out["toks"], out["steps"] = toks, []
    decode = None
    for i in range(STEPS):
        args = (toks[i], positions(jc, len(lens), 1, lens + i), caches,
                lens + i)
        decode = decode or compiled(
            lambda *a: JM.decode_step(params, jc, *a), *args)
        lg, caches = decode(*args)
        out["steps"].append(np.asarray(lg))
    out["caches"] = cache_leaves(jc, caches)
    return out


@functools.cache
def reference(arch: str, dtype: str) -> dict:
    """``run_reference``'s outputs, once a process, with the tolerance and
    the port's model on the same weights."""
    out = run_reference(arch, dtype)
    out["arch"], out["dtype"] = arch, dtype
    out["tol"] = F32_TOL if dtype == "f32" else BF16_TOL
    out["model"] = M.params_from_numpy(out["pc"], out["tree"], "cpu")
    return out


def check_forward(ref):
    """The port's forward, logits and pooled embeddings against the
    reference's."""
    model, tol = ref["model"], ref["tol"]
    x, p = t(ref["x"]), t(ref["p"])
    h = M.forward(model, x, p)
    close(h, ref["h"], tol)
    close(M.logits_fn(model, h), ref["logits"], tol)
    close(M.forward(model, x, p, exact_moe=True), ref["h_exact"], tol)
    # the reference's embed_sequence pools its forward's hidden states
    close(M.embed_sequence(model, x, p), ref["h"][:, -1], tol)
    close(M.embed_sequence(model, x, p, pool="mean"),
          ref["h"].astype(np.float32).mean(1), tol)


def check_prefill_and_decode(ref):
    """Prefill of two prompts into two lanes (logits, every cache leaf),
    then four decode steps of both (logits) and the caches after them."""
    model, tol, pc = ref["model"], ref["tol"], ref["pc"]
    caches = M.init_caches(pc, len(PROMPTS), SMAX, "cpu")
    for lane, (pr, (lg_want, c_want)) in enumerate(zip(ref["prompts"],
                                                       ref["prefill"])):
        lg, one = M.prefill(model, t(pr), t(positions(pc, 1, len(pr[0]))),
                            SMAX)
        close(lg, lg_want, tol)
        for got, want in zip(one, c_want):
            assert set(got) == set(want)
            for k in want:
                close(got[k], want[k], tol)
        caches = _set_lane(caches, lane, one)
    lens = np.array(PROMPTS, np.int32)
    for i in range(STEPS):
        lg, caches = M.decode_step(
            model, t(ref["toks"][i]), t(positions(pc, len(lens), 1,
                                                  lens + i)),
            caches, t(lens + i))
        close(lg, ref["steps"][i], tol)
    for got, want in zip(caches, ref["caches"]):
        for k in want:
            close(got[k], want[k], tol)


# ---------------------------------------------------------------------------
# training: loss_fn and jax.grad
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 2, 12


def train_batch(mc, rng, b: int = TRAIN_B, s: int = TRAIN_S) -> dict:
    """A batch for ``loss_fn``: inputs, targets with the last two of lane
    0 padded (−1), positions."""
    targets = rng.integers(0, mc.vocab, (b, s)).astype(np.int32)
    targets[0, -2:] = -1
    return dict(inputs=inputs(mc, rng, b, s), targets=targets,
                positions=positions(mc, b, s))


@functools.cache
def train_reference(arch: str, remat: str) -> dict:
    """The reference's ``value_and_grad`` of its ``loss_fn`` on the arch's
    f32 smoke config at ``remat`` (compiled, excess precision off): total,
    loss, aux, ntok and the grad tree, with the batch and weights."""
    jc, pc = configs(arch, "f32")
    jc, pc = jc.with_overrides(remat=remat), pc.with_overrides(remat=remat)
    params = jax_params(arch, "f32")
    batch = train_batch(jc, np.random.default_rng(
        zlib.crc32(f"{arch}/train".encode())))
    fn = compiled(lambda p, b: jax.value_and_grad(
        lambda p: JM.loss_fn(p, jc, b), has_aux=True)(p), params, batch)
    (total, m), grads = fn(params, batch)
    return dict(pc=pc, tree=jax.tree.map(np.asarray, params), batch=batch,
                total=float(total), loss=float(m["loss"]),
                aux=float(m["aux"]), ntok=int(m["ntok"]),
                grads=jax.tree.map(np.asarray, grads))


def port_train(ref: dict) -> dict:
    """The port's ``loss_fn`` and its grads (autograd) on the reference's
    weights and batch; the grads in the reference's layout."""
    pc = ref["pc"]
    model = M.params_from_numpy(pc, ref["tree"], "cpu")
    model.requires_grad_(True)
    total, m = M.loss_fn(model, {k: t(v) for k, v in ref["batch"].items()})
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    total, m = total.detach(), {k: v.detach() for k, v in m.items()}
    return dict(total=float(total), loss=float(m["loss"]),
                aux=float(m["aux"]), ntok=int(m["ntok"]),
                grads=M.params_to_numpy(pc, dict(zip(names, grads))))


def check_loss(ref: dict, got: dict, tol=F32_TOL) -> None:
    assert got["ntok"] == ref["ntok"]
    for k in ("total", "loss", "aux"):
        close(got[k], ref[k], tol)


def check_grads(ref: dict, got: dict, tol=F32_TOL) -> None:
    """Leaf for leaf: the same tree, every grad within ``tol``."""
    want, have = ref["grads"], got["grads"]
    assert jax.tree.structure(want) == jax.tree.structure(have)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), h in zip(paths, jax.tree.leaves(have)):
        assert w.shape == h.shape, (jax.tree_util.keystr(path), w.shape,
                                    h.shape)
        np.testing.assert_allclose(h, np.asarray(w, np.float32), **tol,
                                   err_msg=jax.tree_util.keystr(path))
