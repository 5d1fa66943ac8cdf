"""Architecture registry (port of ``repro.configs.registry``): the 10
assigned architectures as selectable configs.

Each ``src/repro_torch/configs/<arch>.py`` defines ``spec() -> ArchSpec``
with the published configuration plus a reduced smoke config of the same
family. Shape set: train_4k, prefill_32k, decode_32k, long_500k;
``supported`` encodes the skip rules: decode shapes skip for encoder-only
archs, and long_500k runs only for sub-quadratic archs (SSM / hybrid / SWA
/ local-global). ``input_specs`` builds stand-ins for every model input of
an (arch × shape) cell: empty tensors of the reference's shapes and dtypes
on the ``meta`` device (nothing allocated), or fake tensors on any device
under ``FakeTensorMode`` (the dry-run pattern).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib

import torch

from repro_torch.models import model as M

ARCH_IDS = (
    "rwkv6_7b",
    "qwen2_vl_72b",
    "qwen3_moe_235b_a22b",
    "deepseek_v2_236b",
    "h2o_danube_3_4b",
    "llama3_405b",
    "tinyllama_1_1b",
    "gemma2_9b",
    "hubert_xlarge",
    "jamba_1_5_large_398b",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # dense | moe | ssm | vlm | audio | hybrid
    model: M.ModelConfig
    smoke: M.ModelConfig              # reduced same-family config
    subquadratic: bool = False        # can run long_500k
    source: str = ""                  # [source; verified-tier]
    notes: str = ""


@functools.cache
def get(arch_id: str) -> ArchSpec:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    spec = importlib.import_module(f"repro_torch.configs.{arch_id}").spec()
    assert spec.arch_id == arch_id, (spec.arch_id, arch_id)
    return spec


def all_specs() -> list[ArchSpec]:
    return [get(a) for a in ARCH_IDS]


def supported(spec: ArchSpec, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and spec.model.encoder_only:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not spec.subquadratic:
        return False, "pure full-attention arch: O(S^2) attention at 500k"
    return True, ""


def cells() -> list[tuple[str, str, bool, str]]:
    """All 40 (arch, shape) cells with their skip status."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = supported(get(a), s)
            out.append((a, s, ok, why))
    return out


# ---------------------------------------------------------------------------
# input specs (empty stand-ins; nothing allocated on ``meta``)
# ---------------------------------------------------------------------------

def _pos_shape(mc: M.ModelConfig, b: int, s: int):
    return (b, s) if mc.pos_dims == 1 else (b, s, mc.pos_dims)


def _inputs(mc: M.ModelConfig, b: int, s: int, device):
    if mc.input_kind == "tokens":
        return torch.empty((b, s), dtype=torch.int32, device=device)
    return torch.empty((b, s, mc.frontend_dim), dtype=torch.bfloat16,
                       device=device)


def input_specs(mc: M.ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """Stand-ins for every input of the cell's step function: ``inputs``,
    ``targets`` and ``positions`` (train), ``inputs`` and ``positions``
    (prefill), ``tokens``, ``positions``, ``caches`` (one dict a layer, of
    an s-long cache) and ``cache_index`` (decode)."""
    b, s = shape.batch, shape.seq
    i32 = dict(dtype=torch.int32, device=device)
    if shape.kind == "train":
        return dict(inputs=_inputs(mc, b, s, device),
                    targets=torch.empty((b, s), **i32),
                    positions=torch.empty(_pos_shape(mc, b, s), **i32))
    if shape.kind == "prefill":
        return dict(inputs=_inputs(mc, b, s, device),
                    positions=torch.empty(_pos_shape(mc, b, s), **i32))
    # decode: one new token against an s-long cache
    return dict(tokens=torch.empty((b, 1), **i32),
                positions=torch.empty(_pos_shape(mc, b, 1), **i32),
                caches=M.init_caches(mc, b, s, device),
                cache_index=torch.empty((b,), **i32))
