"""Error-feedback int8 gradient all-reduce (port of
``repro.optim.compress``).

Each shard quantizes its share of the gradient plus the residual it
carried from the previous step to int8 with one scale per block of 256
values, and keeps what quantization lost as the next residual (error
feedback, Karimireddy et al., 2019, makes the compression unbiased over
time):

    q, scale, err' = quantize(g/dp + err)
    g' = dequant(Σ q  (in int32, exact), mean of the scales)

The reduction runs on the port's one-controller mesh (``core.distributed``
``DeviceMesh`` and ``psum``): the shards' int8 blocks are summed in int32
and their scales averaged, and every shard gets the same result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import DeviceMesh, psum

_BLOCK = 256   # values per quantization scale


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization of a flat f32 vector →
    (int8 (n/256, 256), f32 scales (n/256,)); the rounding is half to
    even, as ``jnp.round``'s."""
    pad = (-x.shape[0]) % _BLOCK
    xf = torch.nn.functional.pad(x, (0, pad)).reshape(-1, _BLOCK)
    scale = xf.abs().amax(1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(scale, min=1e-30)),
                    -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _dequantize(q: torch.Tensor, scale: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scale[:, None]).reshape(-1)[:n]


def ef_quantized_psum(flat_grads, errs) -> tuple[list, list]:
    """Error-feedback int8 psum over the shards: ``flat_grads[s]`` and
    ``errs[s]`` are shard s's (n,) f32 local gradient and residual, each on
    its shard's device. Returns (the reduced gradient on each shard's
    device, identical across shards; each shard's new residual)."""
    dp = len(flat_grads)
    n = flat_grads[0].shape[0]
    qs, scales, new_errs = [], [], []
    for g, err in zip(flat_grads, errs):
        target = g / dp + err
        q, scale = _quantize(target)
        new_errs.append(target - _dequantize(q, scale, n))
        qs.append(q.to(torch.int32))
        scales.append(scale)
    # int8 summed exactly in i32 (≤ 512 × 127 fits easily); the scales
    # differ per shard, so the wire payload stays int8 at the cost of a
    # shared mean scale (the reference's approximation)
    dev = flat_grads[0].device
    reduced = _dequantize(psum(qs, dev), psum(scales, dev) / dp, n)
    return [reduced.to(g.device) for g in flat_grads], new_errs


def make_compressed_allreduce(mesh: DeviceMesh, axes, n: int):
    """``(flat_grad, err) -> (reduced, new_err)`` over ``axes`` of
    ``mesh``, for a gradient and residual replicated on every shard (the
    reference's ``P()`` specs): each shard of those axes quantizes its own
    copy, and the result is the first shard's (all are equal)."""
    devices = mesh.shard_devices(axes)

    def fn(flat_grad: torch.Tensor, err: torch.Tensor):
        if flat_grad.shape != (n,):
            raise ValueError(f"expected a flat ({n},) gradient, got "
                             f"{tuple(flat_grad.shape)}")
        reduced, new_errs = ef_quantized_psum(
            [flat_grad.to(d) for d in devices], [err.to(d) for d in devices])
        return reduced[0], new_errs[0]

    return fn


def flatten_grads(grads: dict) -> tuple[torch.Tensor, tuple]:
    """A dict of tensors → (one flat f32 vector in the dict's order, what
    ``unflatten_grads`` needs to rebuild it)."""
    names = list(grads)
    flat = torch.cat([grads[k].float().reshape(-1) for k in names])
    return flat, (names, [grads[k].shape for k in names],
                  [grads[k].dtype for k in names],
                  [grads[k].numel() for k in names])


def unflatten_grads(flat: torch.Tensor, meta) -> dict:
    names, shapes, dtypes, sizes = meta
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    return {k: flat[offs[i]:offs[i + 1]].reshape(shape).to(dtype)
            for i, (k, shape, dtype) in enumerate(zip(names, shapes, dtypes))}
