"""Plain torch oracles (port of ``src/repro/kernels/ref.py``).

The correctness ground truth beside the kernels' own plain versions:
the densified product and the row-by-row CSR product, in float32, on
whatever device their operands are on.  ``CompiledSpmm``'s ``dense``
and ``ref`` backends are these oracles.
"""
from __future__ import annotations

import numpy as np
import torch


def spmm_dense_ref(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A·X with A densified — the simplest oracle."""
    return a_dense.float() @ x.float()


def spmm_coo_ref(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor, m: int) -> torch.Tensor:
    """The CSR oracle's compute on a structure already expanded to one
    (row, col) pair per nonzero, as int64 tensors on x's device."""
    prod = vals[:, None].float() * x[cols].float()
    return torch.zeros((m, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, rows, prod)


def spmm_csr_ref(row_ptr, col_indices, vals: torch.Tensor, x: torch.Tensor,
                 m: int) -> torch.Tensor:
    """Row-by-row CSR oracle (Algorithm 1 of the paper, vectorized over d
    via CCM — Algorithm 2).  Host-side structure, torch compute."""
    rows = np.repeat(np.arange(m), np.diff(np.asarray(row_ptr)))
    rows = torch.from_numpy(rows).to(x.device)
    cols = torch.from_numpy(np.asarray(col_indices, np.int64)).to(x.device)
    return spmm_coo_ref(rows, cols, vals, x, m)
