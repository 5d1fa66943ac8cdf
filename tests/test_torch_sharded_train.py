"""``train.sharded_train_step`` and the sharded serving entry points on a
real 4-rank gloo group, mesh (2, 2), against the plain port
(``make_train_step``, ``prefill``, ``decode_step``), which
``tests/test_torch_train*.py`` and ``tests/test_torch_lm*.py`` hold to the
JAX package.

Training: for the smoke configs of every block kind (GQA, MLA, M-RoPE with
a frontend, MoE, RWKV, Mamba) in f32, each rank builds the model from one
seed and takes two steps on the same ``SyntheticLM`` batches (2
micro-batches), sharded and plain. Held within 1e-5: each
step's loss and grad norm (relative), the grads (relative to the largest),
and the parameters after two plain-SGD steps; under AdamW (the dry run's
optimizer) the losses, grad norms and the first moments after the first
step (linear in its grads). AdamW's parameters are not held at 1e-5: Adam
divides each grad by its own magnitude, so an element whose grad is near
zero turns a last-bit difference of summation order (the grads agree to
~1e-7) into an update difference of a sizeable share of lr, and the
second step's grads and moments inherit it.

Serving: every decoder's smoke config prefills 17 tokens into caches of
24 (a windowed layer's ring of 16 wraps) and decodes 3 steps at ragged
cache indices, under ``model.activation_sharding`` with the caches laid
out by ``sharding.cache_specs``: with 4 lanes the batch goes over data and
the caches' sequence over model, with 1 lane the sequence over both, so
the writes land on different shards and the flash decoding combines
shards. Its prefill and decode logits and its caches after the last step
are held to the plain entry points' within 1e-5 of the largest; hubert's
(encoder-only) forward logits too.
"""
import multiprocessing as mp
import zlib

import numpy as np
import pytest
import torch

ARCHS = ("tinyllama_1_1b", "qwen3_moe_235b_a22b", "deepseek_v2_236b",
         "rwkv6_7b", "jamba_1_5_large_398b", "qwen2_vl_72b")
SERVE_ARCHS = ("tinyllama_1_1b", "gemma2_9b", "h2o_danube_3_4b",
               "qwen2_vl_72b", "qwen3_moe_235b_a22b", "deepseek_v2_236b",
               "rwkv6_7b", "jamba_1_5_large_398b", "hubert_xlarge")
WORLD = 4
RTOL = 1e-5
PROMPT, SMAX, STEPS = 17, 24, 3
LENS = np.array([17, 9, 20, 12], np.int32)    # each lane's first index


def _sgd(log: list):
    """Plain SGD that records the (full) grads it applies."""
    from torch.distributed.tensor import DTensor
    from repro_torch.optim import Optimizer

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        log.append({n: (g.full_tensor() if isinstance(g, DTensor) else g)
                    .detach().clone() for n, g in grads.items()})
        for n, p in params.items():
            p.sub_(lr * grads[n])
        return params, state

    return Optimizer(init=init, update=update)


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def _worker(rank: int, store_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.loop import make_train_step, sharded_train_step
    mesh = make_local_mesh(2, device_type="cpu")
    out = {}
    for arch in ARCHS:
        mc = get(arch).smoke.with_overrides(dtype=torch.float32)
        src = SyntheticLM(vocab=mc.vocab, seq_len=16, global_batch=8, seed=7,
                          pos_dims=mc.pos_dims)
        batches = [{k: torch.from_numpy(v) for k, v in src.batch_at(i).items()}
                   for i in range(2)]
        for opt_name in ("sgd", "adamw"):
            for kind in ("plain", "sharded"):
                model = M.init_params(mc, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
                grads: list = []
                opt = _sgd(grads) if opt_name == "sgd" else adamw()
                state = opt.init(dict(model.named_parameters()))
                if kind == "plain":
                    step = make_train_step(mc, opt, lambda s: 1e-2,
                                           microbatches=2)
                else:
                    step, _, _ = sharded_train_step(mc, opt, lambda s: 1e-2,
                                                    mesh, microbatches=2)
                hist = []
                key = f"{arch}/{opt_name}/{kind}"
                for i, b in enumerate(batches):
                    model, state, m = step(model, state, b, i)
                    hist.append([float(m["loss"]), float(m["grad_norm"])])
                    if opt_name == "adamw" and i == 0:
                        for n, t in state["mu"].items():
                            out[f"{key}/mu/{n}"] = _full(t).numpy()
                out[f"{key}/hist"] = np.array(hist)
                if opt_name == "sgd":
                    for n, p in model.named_parameters():
                        out[f"{key}/param/{n}"] = _full(p).numpy()
                    for i, g in enumerate(grads):
                        for n, t in g.items():
                            out[f"{key}/grad{i}/{n}"] = t.numpy()
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def _inputs(mc, rng, b: int, s: int) -> np.ndarray:
    """Token ids, or a frontend arch's frame embeddings (``lm_ref``'s)."""
    if mc.input_kind == "embeddings":
        return rng.normal(size=(b, s, mc.frontend_dim)).astype(np.float32)
    return rng.integers(0, mc.vocab, (b, s)).astype(np.int32)


def _positions(mc, b: int, s: int, start) -> np.ndarray:
    """(b, s) positions from each lane's ``start``, or M-RoPE's (b, s, 3)
    streams (t, t//2, t%3) (``lm_ref``'s)."""
    t = np.arange(s, dtype=np.int32) + np.asarray(start, np.int32)[:, None]
    if mc.pos_dims == 3:
        return np.stack([t, t // 2, t % 3], -1).astype(np.int32)
    return t


def _serve_worker(rank: int, store_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    import contextlib
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    mesh = make_local_mesh(2, device_type="cpu")
    out = {}
    for arch in SERVE_ARCHS:
        mc = get(arch).smoke.with_overrides(dtype=torch.float32)
        for B in ((4,) if mc.encoder_only else (4, 1)):
            rng = np.random.default_rng(zlib.crc32(f"{arch}/{B}".encode()))
            x = _inputs(mc, rng, B, PROMPT)
            toks = [_inputs(mc, rng, B, 1) for _ in range(STEPS)]
            for kind in ("plain", "sharded"):
                key = f"{arch}/{B}/{kind}"
                model = M.init_params(mc, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
                lay, ctx = torch.from_numpy, contextlib.nullcontext()
                if kind == "sharded":
                    S.distribute_model(model, mesh)
                    lay = lambda a: S.shard_batch(torch.from_numpy(a), mesh)
                    ctx = M.activation_sharding(S.make_act_sharder(mesh),
                                                S.make_param_pinner(mesh))
                with implicit_replication(), ctx:
                    p = lay(_positions(mc, B, PROMPT, np.zeros(B)))
                    if mc.encoder_only:
                        lg = M.logits_fn(model, M.forward(model, lay(x), p))
                        out[f"{key}/logits"] = _full(lg).numpy()
                        continue
                    lg, caches = M.prefill(model, lay(x), p, SMAX)
                    out[f"{key}/prefill"] = _full(lg).numpy()
                    if kind == "sharded":
                        specs = S.cache_specs(caches, mesh, batch=B)
                        caches = [{n: S.place(t, mesh,
                                              S.placements(sp[n], mesh))
                                   for n, t in c.items()}
                                  for c, sp in zip(caches, specs)]
                    for i in range(STEPS):
                        idx = LENS[:B] + i
                        lg, caches = M.decode_step(
                            model, lay(toks[i]), lay(_positions(mc, B, 1, idx)),
                            caches, lay(idx))
                        out[f"{key}/step{i}"] = _full(lg).numpy()
                    for j, c in enumerate(caches):
                        for n, t in c.items():
                            out[f"{key}/cache{j}/{n}"] = _full(t).numpy()
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def _spawn(target, tmp):
    out = tmp / "out.npz"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, str(tmp / "store"), str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _spawn(_worker, tmp_path_factory.mktemp("sharded_train"))


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    return _spawn(_serve_worker, tmp_path_factory.mktemp("sharded_serve"))


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_norm(runs, arch, opt):
    s, p = runs[f"{arch}/{opt}/sharded/hist"], runs[f"{arch}/{opt}/plain/hist"]
    np.testing.assert_allclose(s, p, rtol=RTOL, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_and_sgd_params(runs, arch):
    pre = f"{arch}/sgd"
    names = [k.split("/", 4)[4] for k in runs if k.startswith(f"{pre}/plain/param/")]
    assert names
    for n in names:
        for i in range(2):
            assert _rel(runs[f"{pre}/sharded/grad{i}/{n}"],
                        runs[f"{pre}/plain/grad{i}/{n}"]) <= RTOL, (n, i)
        np.testing.assert_allclose(runs[f"{pre}/sharded/param/{n}"],
                                   runs[f"{pre}/plain/param/{n}"],
                                   rtol=0, atol=RTOL, err_msg=n)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_moments(runs, arch):
    pre = f"{arch}/adamw"
    names = [k.split("/", 4)[4] for k in runs if k.startswith(f"{pre}/plain/mu/")]
    assert names
    for n in names:
        assert _rel(runs[f"{pre}/sharded/mu/{n}"],
                    runs[f"{pre}/plain/mu/{n}"]) <= RTOL, n


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode(serve_runs, arch):
    keys = [k.split("/", 3)[3] for k in serve_runs
            if k.startswith(f"{arch}/4/plain/")]
    assert keys
    for B in (4, 1):
        for k in keys:
            want = serve_runs.get(f"{arch}/{B}/plain/{k}")
            if want is None:
                continue
            got = serve_runs[f"{arch}/{B}/sharded/{k}"]
            assert got.shape == want.shape, (B, k)
            assert _rel(got, want) <= RTOL, (B, k, _rel(got, want))


def test_donate_false_leaves_the_given_model(tmp_path):
    """Without ``donate`` the step distributes copies: the model and state
    given stay plain tensors, unchanged, and the returned model took the
    step (one rank, mesh (1, 1))."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.loop import make_train_step, sharded_train_step
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, device_type="cpu")
        mc = get("tinyllama_1_1b").smoke.with_overrides(dtype=torch.float32)
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
            vocab=mc.vocab, seq_len=16, global_batch=4, seed=7).batch_at(0)
            .items()}
        model = M.init_params(mc, device="cpu",
                              generator=torch.Generator().manual_seed(3))
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = adamw()
        state = opt.init(dict(model.named_parameters()))
        step, _, _ = sharded_train_step(mc, opt, lambda s: 1e-2, mesh,
                                        donate=False)
        out, _, m = step(model, state, batch, 0)
        for n, p in model.named_parameters():
            assert not isinstance(p, DTensor)
            assert torch.equal(p, before[n]), n
        assert all(isinstance(p, DTensor) for p in out.parameters())
        assert int(state["step"]) == 0
        plain = make_train_step(mc, opt, lambda s: 1e-2)
        _, _, pm = plain(model, opt.init(dict(model.named_parameters())),
                         batch, 0)
        np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                                   rtol=RTOL)
    finally:
        dist.destroy_process_group()
