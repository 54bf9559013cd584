"""Process groups and device meshes (a port of ``repro.launch.mesh``).

The reference builds ``jax.make_mesh`` meshes over the devices of one
controller.  Here every rank is a process: :func:`init_process_group`
starts the group with the backend its device names (``nccl`` for ``cuda``,
``gloo`` only when the caller names the CPU; there is no fallback from one
to the other), and :func:`make_mesh` / :func:`make_host_mesh` lay a
``torch.distributed`` ``DeviceMesh`` over the group's ranks, row-major as
``jax.make_mesh`` lays devices.  Nothing here runs at import.

:func:`make_production_mesh` lays the dry-run's 256- and 512-rank meshes
over a fake group (:func:`start_fake_group`), in which one process plays
one rank and every collective returns at once.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

#: the timeout every process group of the port starts with: a rank that
#: raises leaves the others in a collective, and this bounds their wait
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def backend_for(device=None) -> str:
    """``nccl`` for a CUDA device (the default), ``gloo`` for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {dev}")


def init_process_group(device=None, *, rank: int, world_size: int,
                       init_method: str,
                       timeout: datetime.timedelta = GROUP_TIMEOUT) -> str:
    """Start the default process group for ``device`` (``cuda`` unless the
    caller names the CPU) and return its backend.  ``init_method`` is a
    ``file://`` or ``tcp://`` address; every rank passes the same one."""
    backend = backend_for(device)
    dev = resolve_device(device)
    if dev.type == "cuda":           # one card per rank, before NCCL starts
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return backend


def _device_type(device) -> str:
    return resolve_device(device).type


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default group (the reference's ``compat_make_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; 2 pods = 512 with a leading "pod" axis,
    over a default group of as many ranks: the dry-run's fake group
    (:func:`start_fake_group`).  The mesh's device type is ``meta``, the
    dry-run's device: ``distribute_tensor`` moves a tensor to the mesh's
    device type, and a meta tensor cannot be copied to the CPU, so a
    ``cpu`` mesh would need real storage for every weight."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device="meta")


def start_fake_group(world_size: int, rank: int = 0) -> None:
    """Start a default group of ``world_size`` ranks in which this process
    is ``rank`` and no other rank runs: torch's ``fake`` backend
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    return at once and move nothing.  Raises if a default group is
    running: the dry-run never takes over another group."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already running")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def end_fake_group() -> None:
    """End the group :func:`start_fake_group` started, with the mesh
    context and the groups cached over it; a no-op without one."""
    from repro_torch.parallel import mesh_ctx
    mesh_ctx.clear_context()
    mesh_ctx.forget_groups()
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the default group is {dist.get_backend()}, "
                               "not the dry-run's fake group")
        dist.destroy_process_group()


def dp_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def make_host_mesh(n_devices: int | None = None, tp: int = 1, device=None):
    """``(n // tp, tp)`` mesh named ``("data", "model")`` over the group's
    ``n`` ranks (tests, examples, the smoke script)."""
    n = n_devices or dist.get_world_size()
    if n % tp:
        raise ValueError(f"{n} ranks do not split into tensor-parallel groups "
                         f"of {tp}")
    return make_mesh((n // tp, tp), ("data", "model"), device)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or of any object with a
    ``.shape`` dict (the reference's ``Mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.mesh.shape))


def mesh_from_env(device=None, tp: int = 1):
    """``(device, mesh, started)``.  Under ``torchrun`` (``RANK`` and
    ``WORLD_SIZE`` set) the default group is started for ``device`` unless
    it runs already (``started`` says whether this call started it), each
    rank on its own card (``LOCAL_RANK``), and the mesh is
    :func:`make_host_mesh`'s ``(world / tp, tp)``.  Without that
    environment: one device, no mesh, and ``tp`` must be 1."""
    dev = resolve_device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        if tp != 1:
            raise ValueError(f"--tp {tp} needs ranks: start the driver under "
                             "torchrun")
        return dev, None, False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    started = not dist.is_initialized()
    if started:
        init_process_group(dev, rank=rank, world_size=world,
                           init_method="env://")
    return dev, make_host_mesh(tp=tp, device=dev), started
