"""Elastic re-meshing: resume training on a different device count (port
of ``src/repro/ft/elastic.py``).

When a pod (or host) is lost, the controller:
  1. picks the largest supported mesh from the surviving device count
     (shrinking the *data* axis first — TP groups must stay intact
     because param shards on the model axis are co-located);
  2. re-resolves every sharding rule against the new mesh (the rules in
     distributed/sharding.py are divisibility-checked, so they degrade
     gracefully);
  3. restores the latest checkpoint with the new shardings
     (ft/checkpoint.py checkpoints are mesh-portable), or moves the live
     state with :func:`remesh_state`, and builds the step anew.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from ..distributed.sharding import (LogicalMesh, logical_mesh, shard_tree,
                                    spread)
from ..kernels.ops import resolve_device


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int


def plan_remesh(available_devices: int, *, model_parallel: int,
                prefer_pods: bool = True) -> ElasticPlan:
    """Largest (data, model) mesh with model axis preserved."""
    if available_devices < model_parallel:
        raise RuntimeError(
            f"cannot keep TP={model_parallel} with only "
            f"{available_devices} devices")
    data = available_devices // model_parallel
    # data axis must be a power-of-two divisor chain for batch division
    d = 1
    while d * 2 <= data:
        d *= 2
    used = d * model_parallel
    return ElasticPlan(mesh_shape=(d, model_parallel),
                       axis_names=("data", "model"),
                       dropped_devices=available_devices - used)


def build_mesh(plan: ElasticPlan, devices=None) -> LogicalMesh:
    """The plan's mesh over the surviving ``devices`` (e.g. the cards
    left, ``cuda:0..k``): one chip a device over the first
    ``prod(mesh_shape)`` of them (``sharding.spread``, which lays out
    ``launch.mesh.make_host_mesh``'s cards too), raising where fewer
    survive, as the reference does; by default every chip on the card,
    as ``make_host_mesh`` builds it."""
    n = math.prod(plan.mesh_shape)
    if devices is None:
        devices = (resolve_device(None),) * n
    elif len(devices) >= n:
        devices = spread(list(devices)[:n], n)
    return logical_mesh(plan.mesh_shape, plan.axis_names, devices)


def remesh_state(state_tree, new_shardings):
    """Move a live (or restored) tree onto a new mesh's placements: each
    leaf gathered whole and placed anew."""
    return shard_tree(state_tree, new_shardings)
