"""Carry the reference's state across to the port.

The reference has no weights; its state is the SpMM instance — a
``CSRMatrix`` whose structure is host numpy and whose values are a JAX
array — and the dense operand.  These take those as numpy arrays (what
``np.asarray`` gives for either package) and build the port's objects,
so one seeded instance can feed both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.csr import CSRMatrix
from .kernels.ops import resolve_device


def csr_from_numpy(shape, row_ptr, col_indices, vals, *,
                   device=None) -> CSRMatrix:
    """The port's ``CSRMatrix`` from the reference's fields; ``vals``
    becomes a float32 tensor on ``device`` (the card unless the caller
    passes ``device="cpu"``)."""
    return CSRMatrix(
        shape=tuple(int(s) for s in shape),
        row_ptr=np.asarray(row_ptr), col_indices=np.asarray(col_indices),
        vals=dense_from_numpy(vals, device=device))


def dense_from_numpy(x, *, device=None) -> torch.Tensor:
    """A float32 tensor on ``device`` holding the numpy array ``x``."""
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        resolve_device(device))
