"""Meshes (port of ``src/repro/launch/mesh.py``).

The model stacks' meshes are :class:`~repro_torch.distributed.sharding.
LogicalMesh` es over single-controller chips, each chip a torch device
(which may repeat: ``make_host_mesh(data=2, model=2)`` puts four chips on
the card).  The sharded SpMM path's chip mesh is the port's
``ChipMesh``.
"""
from __future__ import annotations

import math

from ..distributed.sharding import (ChipMesh, LogicalMesh, chip_mesh,
                                    logical_mesh)
from ..kernels.ops import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> LogicalMesh:
    """16x16 = 256 chips/pod ("data","model"); 2 pods stack a leading
    "pod" axis (the DCN dimension).  The chips are ``meta`` devices
    (shapes only, for the dry run) unless ``devices`` gives at least as
    many devices as the mesh has chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = ("meta",) * math.prod(shape)
    return logical_mesh(shape, axes, devices)


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device=None) -> LogicalMesh:
    """A ``(data, model)`` mesh of ``data * model`` chips, all on
    ``device`` (the card unless ``"cpu"``)."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    dev = resolve_device(device)
    return LogicalMesh(("data", "model"), (data, model),
                       (dev,) * (data * model))


def make_chip_mesh(n_chips: int, device=None) -> ChipMesh:
    """1-D ("chips",) mesh for the sharded fused SpMM path — each chip
    owns a contiguous row range of the plan (``core.spmm`` sharding)."""
    return chip_mesh(n_chips, device)
