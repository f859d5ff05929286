# The meshes, placements and collectives, ported from src/repro/distributed/:
#   sharding     ChipMesh, chip_mesh, resolve_chip_mesh, place_on_chips,
#                run_on_chips (the sharded wrappers' chip loop), aligned16
#                (a 16-byte-aligned operand for the kernels' copies);
#                LogicalMesh and the logical-axis rules (AxisEnv,
#                param_pspec, cache_pspec, param_shardings, batch_shardings,
#                decode_shardings, logits_sharding, replicated,
#                chip_row_sharding), Placement, ShardedTensor, shard, gather
#   collectives  exact_panel_exchange, sharded_x, wire_bytes_ratio,
#                compressed_psum (the int8 wire all-reduce), int8_wire
from .collectives import (compressed_psum, exact_panel_exchange, int8_wire,
                          sharded_x, wire_bytes_ratio)
from .sharding import (AxisEnv, ChipMesh, LogicalMesh, Placement,
                       ShardedTensor, aligned16, batch_shardings,
                       cache_pspec, check_on_mesh, chip_bytes, chip_mesh,
                       chip_row_sharding, chip_windows, decode_shardings,
                       gather, gather_tree, logits_sharding, param_pspec,
                       param_shardings, place_on_chips, replicated,
                       resolve_chip_mesh, resolve_spec, run_on_chips, shard,
                       shard_tree)

__all__ = ["AxisEnv", "ChipMesh", "LogicalMesh", "Placement", "ShardedTensor",
           "aligned16", "batch_shardings", "cache_pspec", "check_on_mesh",
           "chip_bytes", "chip_mesh", "chip_row_sharding", "chip_windows",
           "compressed_psum", "decode_shardings", "exact_panel_exchange",
           "gather", "gather_tree", "int8_wire", "logits_sharding",
           "param_pspec", "param_shardings", "place_on_chips", "replicated",
           "resolve_chip_mesh", "resolve_spec", "run_on_chips", "shard",
           "shard_tree", "sharded_x", "wire_bytes_ratio"]
