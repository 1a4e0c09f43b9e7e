"""Production mesh definition (port of ``repro.launch.mesh``) on
``torch.distributed``'s ``DeviceMesh``.

Functions, so importing this module touches no process group. Each mesh is
built over the default process group the caller has initialised: the NCCL
group of a real launch, or the ``"fake"`` group the dry run
(``repro_torch.launch.dryrun``) initialises at the mesh's world size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over the initialised default group, whose world size
    must be 256 or 512: the mesh never shrinks to fit a smaller group."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs an initialised "
                           f"process group of world size {n}")
    if dist.get_world_size() != n:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs world "
                         f"size {n}, the process group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_host_mesh(model: int = 1, device: str = "cuda") -> DeviceMesh:
    """(data, model) over the cards of this host (``device="cuda"``), or
    over the initialised group's ranks for ``device="cpu"`` (tests), with
    data = count // model."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process group")
    n = torch.cuda.device_count() if device == "cuda" else dist.get_world_size()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh over CPU ranks")
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return DeviceMesh(device, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))
