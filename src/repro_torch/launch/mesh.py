"""Meshes (port of ``src/repro/launch/mesh.py``).

The sharded SpMM path's chip mesh is the port's ``ChipMesh``.  The
training mesh runs at one card: ``make_host_mesh`` gives that layout and
refuses any other, as does ``make_production_mesh``; the model-parallel
meshes wait for the port's mesh and sharding slice (ROADMAP, queue 1:
``distributed/sharding.py``, ``launch/mesh.py``).
"""
from __future__ import annotations

from ..distributed.sharding import ChipMesh, chip_mesh


def _no_mesh(what: str):
    raise NotImplementedError(
        f"{what}: data- and model-parallel meshes wait for the port's mesh "
        f"and sharding slice (distributed/sharding.py's AxisEnv and param "
        f"shardings); the port trains on one card")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 (x 2 pods) mesh: refused."""
    _no_mesh("make_production_mesh")


def make_host_mesh(*, data: int = 1, model: int = 1,
                   device=None) -> ChipMesh:
    """The single-card layout, ``data = model = 1``: a one-chip mesh on
    ``device`` (the card unless ``"cpu"``); any other shape raises."""
    if (data, model) != (1, 1):
        _no_mesh(f"make_host_mesh(data={data}, model={model})")
    return chip_mesh(1, device)


def make_chip_mesh(n_chips: int, device=None) -> ChipMesh:
    """1-D ("chips",) mesh for the sharded fused SpMM path — each chip
    owns a contiguous row range of the plan (``core.spmm`` sharding)."""
    return chip_mesh(n_chips, device)
