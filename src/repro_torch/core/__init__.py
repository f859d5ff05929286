# The paper's primary contribution, JIT-specialized SpMM, ported to
# PyTorch + CUDA (the reference is src/repro/core/).
from .csr import CSRMatrix, random_csr
from .ccm import ccm_register_decomposition, plan_d_tiles, DTiling
from .plan import (SpmmPlan, MixedPlan, MxuBlockRow, FusedEllWorkspace,
                   ShardedFusedWorkspace, BatchedFusedWorkspace,
                   StackedFusedTables, SparseEinsumSpec, SPMM_EINSUM,
                   SPMM_MIXED_EINSUM, SPARSE_ATTN_EINSUM,
                   SPARSE_ATTN_MIXED_EINSUM, build_fused_workspace,
                   build_einsum_workspace,
                   build_mixed_plan, build_sharded_workspace,
                   build_batched_workspace, stack_fused_workspaces,
                   build_plan, build_workspace, choose_merge_width,
                   tag_block_rows, partition_rows_for_chips,
                   workspace_row_map, sharded_workspace_row_maps,
                   STRATEGIES,
                   PLAN_STAGES, MAX_MERGE_WIDTH, MXU_TAG, VPU_TAG)
from .jit_cache import (GLOBAL_CACHE, JitCache, clear_global_cache,
                        mesh_fingerprint)
from .spmm import (CompiledSpmm, compile_spmm, spmm, BACKENDS,
                   FUSED_BACKENDS)

__all__ = [
    "CSRMatrix", "random_csr",
    "ccm_register_decomposition", "plan_d_tiles", "DTiling",
    "SpmmPlan", "MixedPlan", "MxuBlockRow", "FusedEllWorkspace",
    "ShardedFusedWorkspace", "BatchedFusedWorkspace",
    "StackedFusedTables", "SparseEinsumSpec", "SPMM_EINSUM",
    "SPMM_MIXED_EINSUM", "SPARSE_ATTN_EINSUM",
    "SPARSE_ATTN_MIXED_EINSUM",
    "build_fused_workspace", "build_einsum_workspace", "build_mixed_plan",
    "build_sharded_workspace", "build_batched_workspace",
    "stack_fused_workspaces",
    "build_plan", "build_workspace", "choose_merge_width",
    "tag_block_rows", "partition_rows_for_chips",
    "workspace_row_map", "sharded_workspace_row_maps", "STRATEGIES",
    "PLAN_STAGES", "MAX_MERGE_WIDTH", "MXU_TAG", "VPU_TAG",
    "GLOBAL_CACHE", "JitCache", "clear_global_cache", "mesh_fingerprint",
    "CompiledSpmm", "compile_spmm", "spmm", "BACKENDS", "FUSED_BACKENDS",
]
