"""Meshes of the port (``repro/launch/mesh.py``).  Functions, not
module-level constants, so importing this module touches no process
group and no device.

A JAX ``Mesh`` spans many devices from one controller; a torch
``DeviceMesh`` has one rank per device, each its own process.  So:

* :func:`make_production_mesh` builds the reference's production shapes
  and axis names in ONE process on the ``fake`` process-group backend
  (every collective a no-op, every tensor meant to be fake): the rules'
  divisibility, and so the dry run's ledger, line up with the
  reference's, with no card;
* :func:`make_host_mesh` is a ``(1, 1)`` mesh over one device, on the
  device's own backend (NCCL on the card, gloo on the CPU);
* :func:`make_slice_mesh` is a 1-axis mesh over a slice of devices: one
  device, or the ranks of a process group that already spans the slice.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _fake_world(world: int) -> None:
    """The process group of a fake world of ``world`` ranks, this
    process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of world size "
                f"{dist.get_world_size()} is already up; a fake production "
                f"mesh of {world} ranks needs a process of its own")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) with ``"pod"``, on the fake backend in this process."""
    shape, axes = PRODUCTION[multi_pod]
    _fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _single_rank_group(dev: torch.device) -> None:
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(
                f"a process group of world size {dist.get_world_size()} is "
                f"up: a one-device mesh in this process would need every "
                f"rank to build it")
        return
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            **({"device_id": dev} if dev.type == "cuda"
                               else {}))


def make_host_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """A (1, 1) ``("data", "model")`` mesh over ``device``: a process group
    of world size 1 on the device's backend (made here unless one is up;
    ``dist.destroy_process_group()`` ends it)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _single_rank_group(dev)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def make_slice_mesh(devices: Sequence, axis_name: str = "model"
                    ) -> DeviceMesh:
    """A 1-axis mesh named ``axis_name`` over ``devices``.

    One device gives a mesh of one rank.  Several devices need one
    process per device (SPMD): a process group must already span them,
    one rank each, in order, with this process the rank whose device is
    ``devices[rank]``; every rank then calls this with the same slice."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices of more than one type: {devs}")
    if len(devs) == 1:
        dev = resolve_device(devs[0])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _single_rank_group(dev)
        return DeviceMesh(dev.type, [0], mesh_dim_names=(axis_name,))
    if not dist.is_initialized() or dist.get_world_size() != len(devs):
        raise RuntimeError(
            f"a mesh over {len(devs)} devices needs one process per device: "
            f"a torch DeviceMesh is SPMD, unlike a JAX Mesh, which one "
            f"controller drives. Start {len(devs)} processes, give "
            f"torch.distributed.init_process_group a world of {len(devs)}, "
            f"and call this on every rank"
            + ("" if not dist.is_initialized() else
               f" (the process group up here has world size "
               f"{dist.get_world_size()})"))
    rank = dist.get_rank()
    mine = devs[rank]
    if mine.type == "cuda" and mine.index is not None:
        torch.cuda.set_device(mine)
    return DeviceMesh(mine.type, list(range(len(devs))),
                      mesh_dim_names=(axis_name,))
