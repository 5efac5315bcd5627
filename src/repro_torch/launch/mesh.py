"""LM mesh construction over ``torch.distributed``: one process per card.

Twin of the reference's ``launch/mesh.py``.  Functions, not module-level
constants: importing this module touches no device and no process group.
A mesh is a ``DeviceMesh`` with the reference's axis names; the launcher
(``torchrun`` or the caller) starts the world, except for the one-process
host mesh, which starts its own group when none exists.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.interpreter import check_device
from repro_torch.parallel.axes import canonical


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """16 x 16 = 256 cards a pod; ``multi_pod`` adds the 2-pod axis (512).
    The world must already hold exactly that many processes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1
    for n in shape:
        need *= n
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs a world of {need} "
                         f"processes, not {world}")
    return init_device_mesh(check_device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda") -> DeviceMesh:
    """A ``(1, 1)`` ``("data", "model")`` mesh over this process's one
    device (tests, examples, one card).  Starts a one-process group when
    none exists -- gloo for the CPU, NCCL for a card -- over an in-process
    store (no port)."""
    device = check_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(device.type), store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError(f"a host mesh is one process; this world has {dist.get_world_size()}")
    if device.type == "cuda":
        torch.cuda.set_device(canonical(device))
    return init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))


def mesh_desc(mesh) -> str:
    """Each axis's size and name: ``"16datax16model"``."""
    return "x".join(f"{n}{a}" for a, n in zip(mesh.mesh_dim_names, mesh.shape))
