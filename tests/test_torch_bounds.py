"""The int8 tier's certified bounds and the int8 pairwise kernel's exact
arithmetic, on the CPU, against the JAX package.

``ref.pairwise_sq_dists_int8_exact`` repeats the CUDA kernel's own
arithmetic (exact per-group integer dots, then its f32 steps), so the card
tests can demand it bit for bit; here it is held within
``1e-5·(xn+yn)`` of the reference's dequantizing plain version
(``repro.kernels.ref``; the two round the matmul form differently). The
port's ``Int8Tier.pairwise_bounds`` on the CPU — the plain version of the
fused bounds kernel — is held against the reference's on the same carried
store within ``2e-5·(xn+yn) + 1e-6·|value|`` (d̂ differs by the matmul
form's rounding; the bound chain is 1-Lipschitz in d̂ for lb and at most
2-Lipschitz for ub where d̂ dwarfs the slack, as it does for queries
independent of the rows), and bit for bit against the composition it
replaced.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.quant import cascade as jcascade
from repro.quant import store as jstore
from repro_torch.kernels import ops, ref
from repro_torch.quant import build_store, quantize_queries
from repro_torch.quant.cascade import MATMUL_GUARD, Int8Queries, Int8Tier
from repro_torch.quant.store import QuantStore

# (B, N, d, group size): d < gs, d % gs != 0, several groups, gs % 32 != 0
SHAPES = [(1, 1, 1, 128), (3, 5, 7, 128), (9, 33, 64, 32), (16, 40, 128, 64),
          (17, 50, 128, 128), (5, 40, 200, 128), (8, 21, 200, 64),
          (6, 19, 100, 48), (0, 4, 8, 128), (4, 0, 8, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite's parallel workers hold every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _carried(B, N, d, gs):
    """The reference's store over N random rows, carried into the port,
    and B independent queries quantized on its grid by both packages."""
    rng = _rng("bounds", B, N, d, gs)
    v = rng.normal(size=(max(N, 1), d)).astype(np.float32) * 3
    jst = jstore.build_store(jnp.asarray(v), group_size=gs)
    jst = jstore.QuantStore(q=jst.q[:N], scales=jst.scales,
                            norms=jst.norms[:N], err=jst.err[:N],
                            group_size=gs)
    st = QuantStore(q=torch.from_numpy(np.array(jst.q)),
                    scales=torch.from_numpy(np.array(jst.scales)),
                    norms=torch.from_numpy(np.array(jst.norms)),
                    err=torch.from_numpy(np.array(jst.err)),
                    group_size=gs)
    x = rng.normal(size=(B, d)).astype(np.float32) * 3
    jq = jcascade.Int8Tier(jst).encode(jnp.asarray(x))
    qc = Int8Queries(q=torch.from_numpy(np.array(jq.q)),
                     norms=torch.from_numpy(np.array(jq.norms)),
                     err=torch.from_numpy(np.array(jq.err)))
    return st, jst, qc, jq


@pytest.mark.parametrize("B,N,d,gs", SHAPES)
def test_exact_plain_version_matches_the_reference(B, N, d, gs):
    st, jst, qc, _ = _carried(B, N, d, gs)
    got = ref.pairwise_sq_dists_int8_exact(qc.q, st.q, st.scales, qc.norms,
                                           st.norms, group_size=gs)
    want = np.asarray(jref.pairwise_sq_dists_int8(
        jnp.asarray(qc.q.numpy()), jst.q, jst.scales, group_size=gs),
        np.float64)
    assert got.shape == (B, N) and got.dtype == torch.float32
    nsum = qc.norms.double().numpy()[:, None] + st.norms.double().numpy()
    assert np.all(np.abs(got.double().numpy() - want) <= 1e-5 * nsum)


@pytest.mark.parametrize("d,gs", [(200, 64), (100, 48), (64, 32)])
def test_exact_plain_version_is_the_kernel_arithmetic(d, gs):
    """Bit for bit a numpy replica of the kernel's steps: exact integer
    dots per group, f32 ``sum += s²·dot`` in group order from 0, then
    ``max((xn + yn) − 2·sum, 0)``."""
    st, _, qc, _ = _carried(5, 7, d, gs)
    got = ref.pairwise_sq_dists_int8_exact(qc.q, st.q, st.scales, qc.norms,
                                           st.norms, group_size=gs).numpy()
    qx, qy = qc.q.numpy().astype(np.int64), st.q.numpy().astype(np.int64)
    sc = st.scales.numpy()
    f = np.float32
    want = np.empty(got.shape, np.float32)
    for b in range(qx.shape[0]):
        for n in range(qy.shape[0]):
            s = f(0)
            for g in range(len(sc)):
                sl = slice(g * gs, min((g + 1) * gs, d))
                dot = int(qx[b, sl] @ qy[n, sl])
                s = f(s + f(f(sc[g] * sc[g]) * f(dot)))
            v = f(f(qc.norms.numpy()[b] + st.norms.numpy()[n]) - f(2) * s)
            want[b, n] = max(v, f(0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,N,d,gs", SHAPES)
def test_int8_tier_bounds_match_the_reference(B, N, d, gs):
    st, jst, qc, jq = _carried(B, N, d, gs)
    lb, ub = Int8Tier(st).pairwise_bounds(qc, impl=None)
    jlb, jub = jcascade.Int8Tier(jst).pairwise_bounds(jq, impl="ref")
    nsum = qc.norms.double().numpy()[:, None] + st.norms.double().numpy()
    for got, want in ((lb, jlb), (ub, jub)):
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape == (B, N)
        assert np.all(np.abs(got.double().numpy() - want)
                      <= 2e-5 * nsum + 1e-6 * np.abs(want))


@pytest.mark.parametrize("B,N,d,gs", SHAPES)
def test_int8_tier_bounds_on_the_cpu_are_the_composition(B, N, d, gs):
    """The CPU path (the fused kernel's plain version) is bit for bit the
    eager composition the tier ran before the kernel existed, on rows
    [y0, y1) of the store."""
    st, _, qc, _ = _carried(B, N, d, gs)
    y0 = min(N, 3)
    lb, ub = Int8Tier(st).pairwise_bounds(qc, impl="ref", y0=y0)
    yn = st.norms[y0:]
    dhat = ops.pairwise_sq_dists_int8(qc.q, st.q[y0:], st.scales,
                                      group_size=gs, xn=qc.norms, yn=yn)
    slack = qc.err[:, None] + st.err[y0:][None, :]
    guard = MATMUL_GUARD * (qc.norms[:, None] + yn[None, :])
    assert torch.equal(lb, ops.quant_lower_bound(
        torch.clamp_min(dhat - guard, 0.0), slack))
    assert torch.equal(ub, ops.quant_upper_bound(dhat + guard, slack))


def test_bounds_entry_runs_its_plain_version_on_the_cpu():
    rng = _rng("entry")
    st = build_store(torch.from_numpy(
        rng.normal(size=(6, 16)).astype(np.float32)))
    qx, xn, xe = quantize_queries(
        torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32)), st)
    with pytest.raises(ValueError):
        ops.pairwise_bounds_int8(qx, st.q, st.scales, xn=xn, yn=st.norms,
                                 xe=xe, ye=st.err, guard=MATMUL_GUARD,
                                 impl="cuda")
    n0 = ops.launch_counts()["pairwise_bounds_int8"]
    lb, ub = ops.pairwise_bounds_int8(qx, st.q, st.scales, xn=xn,
                                      yn=st.norms, xe=xe, ye=st.err,
                                      guard=MATMUL_GUARD)
    assert ops.launch_counts()["pairwise_bounds_int8"] == n0   # no kernel
    assert lb.shape == ub.shape == (3, 6) and bool((lb <= ub).all())
