"""Meshes (the counterpart of `repro.launch.mesh`).

The LM stack's meshes are `torch.distributed` `DeviceMesh`es over the
process group this process joined (`init_process_group`: torchrun's
environment, or one rank on localhost): NCCL on the card, gloo on the CPU.
The dry run (`launch.dryrun`) joins a fake group of 256 or 512 ranks as
the rank it traces (`init_fake_process_group`), whose collectives move
nothing.
`make_mesh` raises without a process group, or when the mesh's shape does
not multiply to the world size (as JAX's fails over too few devices), or
when the group's backend is not the one asked for: no mesh falls back to
another device or another collective library.

The CV serving mesh (`make_cv_mesh`, `CvMesh`) is only the devices of one
"data" axis: the CV batch path is pure data parallelism over the cards of
one process, with no process group.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device=None) -> None:
    """Join the process group: torchrun's (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) or, without it,
    a group of this one rank on ``tcp://127.0.0.1`` at a free port.  The
    backend is `device`'s (None = "cuda": NCCL; "cpu": gloo).  On the card
    each rank takes the card of its ``LOCAL_RANK`` (0 without it)."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)


def init_fake_process_group(world_size: int, rank: int = 0) -> None:
    """Join a process group of `world_size` ranks as `rank` on PyTorch's
    fake backend (``torch.testing._internal.distributed.fake_pg``): every
    collective returns at once and moves nothing, so one process traces a
    rank's step over a mesh of any size.  Raises `RuntimeError` when this
    torch lacks the fake backend: no dry run falls back to fewer ranks."""
    if not 0 <= rank < world_size:
        raise ValueError(f"init_fake_process_group: rank {rank} of {world_size}")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"this torch ({torch.__version__}) has no fake process group "
                           f"backend (torch.testing._internal.distributed.fake_pg): {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)


def make_mesh(shape, axes, *, device=None, backend: str | None = None):
    """A `DeviceMesh` of `shape` with ``mesh_dim_names=axes`` over the
    initialised process group, on `device`'s type (None = "cuda").  Raises
    `RuntimeError` without a process group, `ValueError` when the shape
    does not multiply to the world size or the group's backend is not
    `backend` (None: NCCL on the card, gloo on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group (launch.mesh.init_process_group, "
                           "or torchrun)")
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} against axes {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"make_mesh: a {shape} mesh needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    want = backend or BACKENDS[dev.type]
    have = dist.get_backend()
    if have != want:
        raise ValueError(f"make_mesh: the process group's backend is {have}, not {want} "
                         f"(device {dev.type})")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None, backend: str | None = None):
    """JAX's production mesh: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") over two pods: 256 or 512 ranks (`backend` as
    in `make_mesh`; the dry run's is "fake")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, backend=backend)


def make_host_mesh(model: int = 1, *, device=None):
    """A ("data", "model") mesh over the whole process group, data = world
    // model (tests, launchers)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh: no process group (launch.mesh.init_process_group, "
                           "or torchrun)")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"make_host_mesh: model {model} does not divide the world size {world}")
    return make_mesh((world // model, model), ("data", "model"), device=device)


@dataclass(frozen=True)
class CvMesh:
    """A one-axis device mesh: ``axis_names == ("data",)``, `devices` the
    `torch.device`s along it, in shard order."""

    devices: tuple
    axis_names: tuple = ("data",)


def make_cv_mesh(data: int | None = None, *, device=None) -> CvMesh:
    """Data-only mesh for the CV serving fan-out (`serve.shard_dispatch`).

    On the card (`device` None or CUDA) it covers the first
    `torch.cuda.device_count()` CUDA devices, capped at `data` when given;
    ``device="cpu"`` gives a one-device CPU mesh.  A one-device mesh leaves
    `CvEngine` serving as without one (the dispatcher engages past one
    data-axis device)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CvMesh(devices=(torch.device("cpu"),))
    n = torch.cuda.device_count()
    data = n if data is None else max(1, min(int(data), n))
    return CvMesh(devices=tuple(torch.device("cuda", i) for i in range(data)))
