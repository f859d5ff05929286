"""Sparse matrix container for the JITSPMM core (port of
``src/repro/core/csr.py``).

CSR is the host-facing format (same as the paper, Fig. 2).  Planning
happens on the *host* copy of the structure arrays (numpy) at dispatch
time; values stay a torch tensor on the caller's device.  The structure
arrays, the fingerprint and ``random_csr`` are byte-for-byte the
reference's, so a seed gives the same instance in both packages and the
port's cache keys hash the same bytes.  ``BCSRMatrix`` waits for a later
slice.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.ops import resolve_device

Shape = Tuple[int, int]


@dataclasses.dataclass
class CSRMatrix:
    """Compressed Sparse Row matrix (paper §II-A, Fig. 2).

    ``row_ptr`` / ``col_indices`` are the *structure* (host numpy, used
    by the planner); ``vals`` is a torch tensor on the device the
    values live on.  ``m x n`` with ``nnz`` nonzeros.
    """

    shape: Shape
    row_ptr: np.ndarray          # (m+1,) int64, host
    col_indices: np.ndarray      # (nnz,) int32, host
    vals: torch.Tensor           # (nnz,) float, any device

    _fingerprint: Optional[str] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.row_ptr = np.asarray(self.row_ptr).astype(np.int64)
        self.col_indices = np.asarray(self.col_indices).astype(np.int32)
        m, n = self.shape
        if self.row_ptr.shape != (m + 1,):
            raise ValueError(f"row_ptr has shape {self.row_ptr.shape}, "
                             f"expected ({m + 1},)")
        if self.row_ptr[0] != 0 or self.row_ptr[-1] != self.nnz:
            raise ValueError("row_ptr must run from 0 to nnz")
        if tuple(self.vals.shape) != (self.nnz,):
            raise ValueError(f"vals has shape {tuple(self.vals.shape)}, "
                             f"expected ({self.nnz},)")

    # -- basic properties ------------------------------------------------
    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    # -- the JIT-cache key -----------------------------------------------
    @property
    def fingerprint(self) -> str:
        """Structure fingerprint: the part of the instance the generated
        code is specialized to.  Values are *not* part of the key — the
        same compiled artifact serves any values with this structure.
        Hashes the same bytes as the reference, so the two packages key
        one instance identically."""
        if self._fingerprint is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(self.shape).tobytes())
            h.update(self.row_ptr.tobytes())
            h.update(self.col_indices.tobytes())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    # -- conversions -------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        dense = torch.zeros((m, n), dtype=self.vals.dtype,
                            device=self.vals.device)
        rows = torch.from_numpy(np.repeat(np.arange(m), self.row_lengths))
        cols = torch.from_numpy(self.col_indices.astype(np.int64))
        dense[rows.to(dense.device), cols.to(dense.device)] = self.vals
        return dense

    @staticmethod
    def from_dense(dense: np.ndarray, tol: float = 0.0, *,
                   device=None) -> "CSRMatrix":
        d = np.asarray(dense)
        mask = np.abs(d) > tol
        row_lengths = mask.sum(axis=1)
        row_ptr = np.zeros(d.shape[0] + 1, dtype=np.int64)
        np.cumsum(row_lengths, out=row_ptr[1:])
        rows, cols = np.nonzero(mask)
        return CSRMatrix(
            shape=d.shape,
            row_ptr=row_ptr,
            col_indices=cols.astype(np.int32),
            vals=torch.from_numpy(d[rows, cols].astype(np.float32)
                                  ).to(resolve_device(device)))

    def transpose_structure(self) -> Tuple["CSRMatrix", np.ndarray]:
        """Host-side CSR transpose (structure + value permutation).

        Returns the transposed matrix and ``order``, the nnz permutation
        with ``vals_t = vals[order]`` — what the backward slice's dX
        artifact is keyed and gathered by.
        """
        m, n = self.shape
        rows = np.repeat(np.arange(m), self.row_lengths)
        cols = self.col_indices
        order = np.lexsort((rows, cols))
        t_rows = cols[order]
        t_cols = rows[order].astype(np.int32)
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(row_ptr[1:], t_rows, 1)
        np.cumsum(row_ptr, out=row_ptr)
        vals = self.vals[torch.from_numpy(order).to(self.vals.device)]
        return CSRMatrix(shape=(n, m), row_ptr=row_ptr, col_indices=t_cols,
                         vals=vals), order


# ---------------------------------------------------------------------------
# Synthetic matrix generators (benchmark/test substrate — the paper uses
# SuiteSparse graphs; we generate structurally similar families offline).
# ---------------------------------------------------------------------------

def random_csr(m: int, n: int, *, density: float = 0.05,
               family: str = "uniform", seed: int = 0,
               dtype: torch.dtype = torch.float32,
               device=None) -> CSRMatrix:
    """Families:
      uniform   — iid Bernoulli structure (GAP-urand-like)
      powerlaw  — Zipf row lengths (twitter/web-graph-like; the skew that
                  motivates nnz/merge-split in the paper)
      banded    — diagonal band (mesh/stencil-like)

    Makes the reference's numpy calls in the reference's order, so a
    seed gives exactly the reference's structure and values.  The values
    are built on the host and moved to ``device`` (the card unless the
    caller passes ``device="cpu"``).
    """
    rng = np.random.default_rng(seed)
    target_nnz = max(1, int(m * n * density))
    if family == "uniform":
        lengths = rng.binomial(n, density, size=m)
    elif family == "powerlaw":
        raw = rng.zipf(1.6, size=m).astype(np.float64)
        raw = np.minimum(raw, n)
        lengths = np.maximum((raw / raw.sum() * target_nnz), 0).astype(np.int64)
        lengths = np.minimum(lengths, n)
    elif family == "banded":
        bw = max(1, int(n * density))
        lengths = np.full(m, bw, dtype=np.int64)
    else:
        raise ValueError(f"unknown family {family!r}")
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    cols = np.empty(nnz, dtype=np.int32)
    for i in range(m):
        li = int(lengths[i])
        if li == 0:
            continue
        if family == "banded":
            start = max(0, min(n - li, i - li // 2))
            cols[row_ptr[i]:row_ptr[i + 1]] = np.arange(start, start + li)
        else:
            cols[row_ptr[i]:row_ptr[i + 1]] = np.sort(
                rng.choice(n, size=li, replace=False))
    vals = torch.from_numpy(rng.standard_normal(nnz)).to(dtype)
    vals = vals.to(resolve_device(device))
    return CSRMatrix(shape=(m, n), row_ptr=row_ptr, col_indices=cols,
                     vals=vals)
