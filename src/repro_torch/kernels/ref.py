"""Plain torch oracles (port of ``src/repro/kernels/ref.py``).

The correctness ground truth beside the kernels' own plain versions:
the densified product, the row-by-row CSR product, one ELL segment, the
block-CSR product and the SDDMM, in float32, on whatever device their
operands are on.  ``CompiledSpmm``'s ``dense`` and ``ref`` backends are
the first two.
"""
from __future__ import annotations

import numpy as np
import torch


def spmm_dense_ref(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Y = A·X with A densified — the simplest oracle."""
    return a_dense.float() @ x.float()


def spmm_ell_segment_ref(cols_pad, vals_pad: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Oracle for one ELL segment: (R_pad, L) cols/vals against X (n, d).

    Padding slots carry val == 0 so they contribute nothing (col 0 is a
    harmless real row — same trick as the kernels)."""
    cols = torch.as_tensor(np.asarray(cols_pad), device=x.device).long()
    return torch.einsum("rl,rld->rd", vals_pad.float(), x[cols].float())


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


def spmm_bcsr_ref(block_row_ptr, block_cols, block_vals: torch.Tensor,
                  x: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """Block-CSR oracle: per-block (bm x bk)·(bk x d) matmuls, summed
    into each block-row.  X's rows are zero-padded up to the block grid
    (the reference slices each block-column's rows out of X)."""
    counts = np.diff(np.asarray(block_row_ptr))
    n_brows, d = counts.shape[0], x.shape[1]
    brow = torch.from_numpy(np.repeat(np.arange(n_brows), counts)).to(
        x.device)
    bcol = torch.from_numpy(np.asarray(block_cols, np.int64)).to(x.device)
    xg = torch.nn.functional.pad(x.float(), (0, 0, 0, -x.shape[0] % bk))
    panels = xg.reshape(-1, bk, d)[bcol]                  # (nblocks, bk, d)
    prod = torch.bmm(block_vals.float().reshape(-1, bm, bk), panels)
    y = torch.zeros((n_brows, bm, d), dtype=torch.float32, device=x.device)
    return y.index_add_(0, brow, prod).reshape(n_brows * bm, d)


def sddmm_ref(row_ptr, col_indices, dy: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: dA.vals[p] = <dY[row_p], X[col_p]> —
    the structure-restricted gradient of spmm w.r.t. vals."""
    row_ptr = np.asarray(row_ptr)
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    rows = torch.from_numpy(rows).to(x.device)
    cols = torch.from_numpy(np.asarray(col_indices, np.int64)).to(x.device)
    return (dy[rows].float() * x[cols].float()).sum(-1)
