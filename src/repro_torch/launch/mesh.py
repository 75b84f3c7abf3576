"""Production meshes as `torch.distributed` DeviceMeshes, ported from
`repro.launch.mesh`. Functions, not module-level constants: importing
this module starts no process group.

A mesh needs a process group of its size. `init_world` starts one where
none is: from the launcher's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, as `torchrun` sets them), else a world
of one on ``tcp://localhost`` at a free port. The backend is NCCL on the
card and gloo on the CPU. Meshes take the card unless ``device="cpu"``
is passed (`repro_torch.resolve_device`).
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device=None) -> None:
    """Start the default process group for `device`'s type, unless one is
    running."""
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if backend == "nccl":  # the rank's card, before NCCL's communicator
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)


def make_mesh(shape, axes, device=None):
    """A DeviceMesh of `shape` with dim names `axes` over the world's
    first ranks in order, as `jax.make_mesh` takes the first devices
    (every rank of the world must call it)."""
    from torch.distributed.device_mesh import DeviceMesh

    init_world(device)
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 4, device=None):
    """A (data, model) mesh cut to the world's size: a world of one gives
    (1, 1), two ranks (1, 2)."""
    init_world(device)
    n = dist.get_world_size()
    data = min(data, max(n // model, 1))
    if data * model > n:
        model = n // data
    return make_mesh((data, model), ("data", "model"), device)
