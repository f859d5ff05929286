"""repro_torch — the JITSPMM reproduction ported to PyTorch and CUDA for
an NVIDIA H100.

The JAX package ``repro`` is the reference: each module here names the
module it ports by the same path, and the tests hold the two against
each other.  This package imports ``torch`` and numpy, never ``jax`` and
nothing of ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; on the CPU the kernels run their plain
PyTorch versions.
"""
from . import analysis, convert, core, gnn, kernels
from .core import (CompiledSpmm, CSRMatrix, compile_spmm, random_csr,
                   spmm)

__all__ = ["analysis", "convert", "core", "gnn", "kernels", "CompiledSpmm",
           "CSRMatrix", "compile_spmm", "random_csr", "spmm"]
