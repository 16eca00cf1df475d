"""Mesh construction over the ranks of a ``torch.distributed`` process
group: the port of ``repro.launch.mesh``.

FUNCTIONS, not module-level constants: importing this module touches no
process group. The caller initialises the process group first (one
process per rank; nothing on the machine announces a cluster, so the
caller names the store or address, the world size and its rank).

Mesh layout: 16x16 within a pod ("data" x "model": FSDP/DP over data, TP
over model), and a leading "pod" axis (pure DP) for the 2-pod, 512-rank
configuration. A model built under a mesh whose "model" axis is wider
than 1 keeps each rank's tensor-parallel slice (``repro_torch.dist.api``);
the dense, moe and vlm families run on it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve


def _world() -> int:
    if not tdist.is_initialized():
        raise RuntimeError("initialise the torch.distributed process group "
                           "(one process per rank) before building a mesh")
    return tdist.get_world_size()


def _make_mesh(shape: Sequence[int], axes: Sequence[str],
               device: DeviceLike) -> DeviceMesh:
    dev = resolve(device)
    world = _world()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} {tuple(axes)} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> DeviceMesh:
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, on ``device`` ("cuda": NCCL). Raises
    unless the process group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """("data", "model") mesh over every rank of the process group, on
    ``device``: the production axis names, so the same sharded code paths
    run at any scale. "model" stays 1 wide and every rank goes to "data",
    so the ZeRO-3 sharding and the just-in-time gather are real whenever
    the world has more than one rank."""
    return _make_mesh((_world(), 1), ("data", "model"), device)


def make_cpu_mesh() -> DeviceMesh:
    """``make_mesh`` on the CPU (a gloo process group), as the reference's
    ``make_cpu_mesh`` spans every local device."""
    return make_mesh("cpu")


__all__ = ["make_cpu_mesh", "make_mesh", "make_production_mesh"]
