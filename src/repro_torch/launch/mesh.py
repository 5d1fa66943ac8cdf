"""Production mesh definitions for the LM (port of ``repro.launch.mesh``).

This is torch's SPMD mesh (``torch.distributed.device_mesh.DeviceMesh``,
one process a rank), the layout of the LM dry run and of
``train.loop.sharded_train_step``. The join's mesh is another thing:
``core.distributed.DeviceMesh`` is a list of devices driven by one
controller process.

  single-pod: (data=32, model=8)             — 256 GPUs (32 DGX H100 nodes)
  multi-pod:  (pod=2, data=32, model=8)      — 512 GPUs

The reference's mesh is a TPU v5e pod's (16, 16): every link of its torus
is alike, so its model axis may be 16 wide. A DGX H100 node holds 8 GPUs
on NVLink and reaches other nodes over its NICs, so the model axis
(tensor parallelism, whose collectives run every layer) is 8, inside a
node, and the data axis takes the other 32. Parameters/optimizer state
FSDP-shard over (pod, data); tensor/expert parallelism over model; batch
over (pod, data). See models/sharding.py.

``make_production_mesh`` lays the mesh over a *fake* process group
(``torch.testing._internal.distributed.fake_pg``: every collective is a
no-op), which lets one process trace one rank of a 256- or 512-rank step
on fake tensors, as the reference compiles for 512 placeholder devices.
The group is process-global: ``close_group`` destroys it.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))


def open_fake_group(world_size: int) -> None:
    """Initialize the default process group as a fake group of
    ``world_size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def close_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh over a fake group, opened here (close it with
    ``close_group``)."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    open_fake_group(n)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(model: int = 1, *, device_type: str = "cuda"
                    ) -> DeviceMesh:
    """A (data, model) mesh over the initialized process group's ranks,
    ``model`` of them on the model axis."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model axes of {model}")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
