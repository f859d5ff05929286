# The meshes, placements and collectives, ported from src/repro/distributed/:
#   sharding     ChipMesh, chip_mesh, resolve_chip_mesh, place_on_chips,
#                run_on_chips (the sharded wrappers' chip loop), aligned16
#                (a 16-byte-aligned operand for the kernels' copies);
#                LogicalMesh and the logical-axis rules (AxisEnv,
#                param_pspec, cache_pspec, param_shardings, batch_shardings,
#                decode_shardings, logits_sharding, replicated,
#                chip_row_sharding), Placement, ShardedTensor, shard, gather
#                model_dim, owned_range, gather_slice (a model
#                coordinate's part of a leaf); spread (chips laid out
#                over cards), synchronize (every card of a mesh),
#                card_copy (a copy between cards on a stream of its own)
#                and written (the events it waits for)
#   collectives  exact_panel_exchange, sharded_x, wire_bytes_ratio,
#                compressed_psum (the int8 wire all-reduce), int8_wire;
#                model_sum (the model axis's all-reduce) and the
#                vocabulary-parallel vocab_max, vocab_sumexp, vocab_target
#   model_split  ModelSplit (one data group's model chips: the Megatron
#                split of the stack), SplitTally, kv_heads
from .collectives import (compressed_psum, exact_panel_exchange, int8_wire,
                          model_sum, sharded_x, vocab_max, vocab_sumexp,
                          vocab_target, wire_bytes_ratio)
from .model_split import ModelSplit, SplitTally, kv_heads
from .sharding import (AxisEnv, ChipMesh, LogicalMesh, Placement,
                       ShardedTensor, aligned16, batch_shardings,
                       cache_pspec, card_copy, check_on_mesh, chip_bytes,
                       chip_mesh, chip_row_sharding, chip_windows,
                       decode_shardings, gather, gather_slice, gather_tree,
                       logits_sharding, model_dim, owned_range, param_pspec,
                       param_shardings, place_on_chips, replicated,
                       resolve_chip_mesh, resolve_spec, run_on_chips, shard,
                       shard_tree, spread, synchronize, written)

__all__ = ["AxisEnv", "ChipMesh", "LogicalMesh", "ModelSplit", "Placement",
           "ShardedTensor", "SplitTally", "aligned16", "batch_shardings",
           "cache_pspec", "card_copy", "check_on_mesh", "chip_bytes",
           "chip_mesh", "chip_row_sharding", "chip_windows",
           "compressed_psum", "decode_shardings", "exact_panel_exchange",
           "gather", "gather_slice", "gather_tree", "int8_wire",
           "kv_heads", "logits_sharding", "model_dim", "model_sum",
           "owned_range", "param_pspec", "param_shardings",
           "place_on_chips", "replicated", "resolve_chip_mesh",
           "resolve_spec", "run_on_chips", "shard", "shard_tree",
           "sharded_x", "vocab_max", "vocab_sumexp", "vocab_target",
           "wire_bytes_ratio", "written"]
