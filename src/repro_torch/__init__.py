"""repro_torch — the JITSPMM reproduction ported to PyTorch and CUDA for
an NVIDIA H100.

The JAX package ``repro`` is the reference: each module here names the
module it ports by the same path, and the tests hold the two against
each other.  This package imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on the CPU the kernels run their plain
PyTorch versions.
"""
from . import analysis, configs, convert, core, gnn, kernels, models
from .core import (CompiledSparseAttention, CompiledSpmm, CSRMatrix,
                   compile_sparse_attention, compile_spmm, random_csr,
                   sparse_attention, spmm)

__all__ = ["analysis", "configs", "convert", "core", "gnn", "kernels",
           "models", "CompiledSparseAttention", "CompiledSpmm", "CSRMatrix",
           "compile_sparse_attention", "compile_spmm", "random_csr",
           "sparse_attention", "spmm"]
