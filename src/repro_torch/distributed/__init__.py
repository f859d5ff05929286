# The sharded fused path's chip mesh and X exchange, ported from
# src/repro/distributed/ (the model stacks' logical-axis rules and the
# compressed gradient all-reduce come with the training stack):
#   sharding     ChipMesh, chip_mesh, resolve_chip_mesh, place_on_chips,
#                run_on_chips (the sharded wrappers' chip loop), aligned16
#                (a 16-byte-aligned operand for the kernels' copies)
#   collectives  exact_panel_exchange, sharded_x, wire_bytes_ratio
from .collectives import exact_panel_exchange, sharded_x, wire_bytes_ratio
from .sharding import (ChipMesh, aligned16, check_on_mesh, chip_mesh,
                       chip_windows, place_on_chips, resolve_chip_mesh,
                       run_on_chips)

__all__ = ["ChipMesh", "aligned16", "check_on_mesh", "chip_mesh",
           "chip_windows", "exact_panel_exchange", "place_on_chips",
           "resolve_chip_mesh", "run_on_chips", "sharded_x",
           "wire_bytes_ratio"]
