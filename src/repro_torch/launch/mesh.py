"""Meshes (port of ``src/repro/launch/mesh.py``).

The model stacks' meshes are :class:`~repro_torch.distributed.sharding.
LogicalMesh` es over single-controller chips, each chip a torch device
(which may repeat: ``make_host_mesh(data=2, model=2)`` puts four chips on
the card; with ``cards=4`` each chip has a card of its own, the
reference's one chip a device).  The sharded SpMM path's chip mesh is
the port's ``ChipMesh``.
"""
from __future__ import annotations

import math

import torch

from ..distributed.sharding import (ChipMesh, LogicalMesh, chip_mesh,
                                    logical_mesh, spread)
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


def make_host_mesh(*, data: int = 1, model: int = 1, device=None,
                   cards: int = 1) -> LogicalMesh:
    """A ``(data, model)`` mesh of ``data * model`` chips: all on
    ``device`` (the card unless ``"cpu"``), or with ``cards`` > 1 laid
    out row-major over ``cards`` CUDA cards from ``device``'s (``cuda:0``
    by default), each card a contiguous run of chips
    (``sharding.spread``): on (2, 2), ``cards=4`` puts chip ``i`` on
    ``cuda:i`` and ``cards=2`` each data group on a card of its own.
    Raises where ``cards`` does not divide the chips or runs past the
    visible cards, as the reference asserts ``data * model`` devices."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data}, "
                         f"model={model}")
    if cards < 1:
        raise ValueError(f"cards must be >= 1, got {cards}")
    n = data * model
    if cards == 1:
        return LogicalMesh(("data", "model"), (data, model),
                           (resolve_device(device),) * n)
    first = torch.device("cuda" if device is None else device)
    if first.type != "cuda":
        raise ValueError(f"a mesh over {cards} cards lies on CUDA cards, "
                         f"not on {device!r}")
    first = first.index or 0
    devices = spread([torch.device("cuda", first + i)
                      for i in range(cards)], n)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if first + cards > count:
        raise ValueError(f"cards cuda:{first}..{first + cards - 1} but "
                         f"{count} card(s) visible")
    return LogicalMesh(("data", "model"), (data, model), devices)


def make_chip_mesh(n_chips: int, device=None) -> ChipMesh:
    """1-D ("chips",) mesh for the sharded fused SpMM path — each chip
    owns a contiguous row range of the plan (``core.spmm`` sharding)."""
    return chip_mesh(n_chips, device)
