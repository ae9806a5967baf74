"""Device meshes over ``torch.distributed`` (PyTorch port of
``repro.launch.mesh``).

Single pod: (data=16, model=16) — 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) — 512 ranks.

A mesh spans the default process group, one rank per device: NCCL on
the card, gloo on the CPU (``device="cpu"``, the tests). Nothing tells a
process of its cluster here, so :func:`init_distributed` takes the
rendezvous from its arguments or from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Functions,
not module constants: importing this module touches no device and no
process group.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device="cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: str = "env://") -> torch.device:
    """Join the default process group: NCCL for ``device="cuda"`` (which
    raises without a card, and binds this process to card ``LOCAL_RANK``),
    gloo for ``"cpu"``. ``rank`` / ``world_size`` default to the
    environment's, as torchrun sets them -> the device this rank runs on."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    kw = {}
    if rank is not None:
        kw["rank"] = rank
    if world_size is not None:
        kw["world_size"] = world_size
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method,
                            **kw)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group (tests, examples). Raises without a process group, or
    when the group's size is not the product of ``shape``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
