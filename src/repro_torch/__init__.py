"""repro_torch — the JITSPMM reproduction ported to PyTorch and CUDA for
an NVIDIA H100.

The JAX package ``repro`` is the reference: each module here names the
module it ports by the same path, and the tests hold the two against
each other.  This package imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on the CPU the kernels run their plain
PyTorch versions.  ``mesh=``/``n_chips=`` shard them over a
``ChipMesh``, whose devices may repeat (four chips on one card, or on
the CPU).
"""
from . import (analysis, configs, convert, core, distributed, gnn, kernels,
               models)
from .core import (ChipMesh, CompiledSparseAttention, CompiledSpmm,
                   CSRMatrix, chip_mesh, compile_sparse_attention,
                   compile_spmm, random_csr, resolve_chip_mesh,
                   sparse_attention, spmm)

__all__ = ["analysis", "configs", "convert", "core", "distributed", "gnn",
           "kernels", "models", "ChipMesh", "CompiledSparseAttention",
           "CompiledSpmm", "CSRMatrix", "chip_mesh",
           "compile_sparse_attention", "compile_spmm", "random_csr",
           "resolve_chip_mesh", "sparse_attention", "spmm"]
