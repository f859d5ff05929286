"""K10: the pre-fusion block-CSR SpMM, ``Y (n_brows*bm, d_pad) = A · X``.

Replaces the TPU kernel ``src/repro/kernels/spmm_bcsr.py`` ::
``spmm_bcsr`` (``_kernel``) with the hand-written CUDA kernel
``csrc/spmm_bcsr.cu``.  It is the pre-fusion MXU micro-oracle: every
block-row holds ``kmax`` (bm x bk) blocks, padded with zero blocks that
point at block-column 0, and step ``k`` of block-row ``i`` adds
``block_vals_pad[i*kmax + k] @ X[bc*bk : (bc+1)*bk]`` with
``bc = block_cols_pad[i*kmax + k]``.

What bounds it on an H100: bytes, as K2.  The kernel is K2's block trip
(``csrc/spmm_trips.cuh``) with block-row ``i`` as one MXU descriptor,
in fp32 with K2's roundings (no TF32, no tensor cores), so it equals K2
bit for bit wherever the blocks come in the same order.

:func:`spmm_bcsr_plain` is the plain PyTorch version, K2's plain block
trip over the same steps; the wrapper runs it for CPU tensors, and for
CUDA tensors it launches the kernel or raises.  The reference leaves
the global-``kmax`` padding of a ``BCSRMatrix`` to its callers; here it
is :func:`_pad_to_kmax`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .spmm_bcsr_fused import mxu_trips
from .spmm_ell_fused import SUPPORTED_BM, check_placement

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_INT32_LIMIT = 2 ** 31


def _check(block_cols_pad, block_vals_pad, x, kmax: int) -> None:
    """Validate the kernel's operands before any pointer is taken."""
    if block_cols_pad.dtype != torch.int32 or block_cols_pad.dim() != 1:
        raise ValueError("block_cols_pad must be a 1-D int32 tensor")
    if block_vals_pad.dtype != torch.float32 or block_vals_pad.dim() != 3:
        raise ValueError("block_vals_pad must be a 3-D float32 tensor")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor")
    nsteps, bm, bk = block_vals_pad.shape
    if block_cols_pad.shape[0] != nsteps:
        raise ValueError(f"block_cols_pad has {block_cols_pad.shape[0]} "
                         f"steps, block_vals_pad {nsteps}")
    if kmax < 1 or nsteps % kmax:
        raise ValueError(f"kmax={kmax} must be positive and divide the "
                         f"{nsteps} steps")
    if block_vals_pad.numel() >= _INT32_LIMIT:
        raise ValueError("the value panels exceed 32-bit offsets")
    if bm not in SUPPORTED_BM:
        raise ValueError(f"bm must be one of {SUPPORTED_BM}, got {bm}")
    if bk < 1 or x.shape[0] % bk:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"bk={bk}")
    if nsteps and x.shape[0] == 0:
        raise ValueError("blocks index into an empty x")
    check_placement({"block_cols_pad": block_cols_pad,
                     "block_vals_pad": block_vals_pad}, x)


def spmm_bcsr_plain(block_cols_pad, block_vals_pad, x, *,
                    kmax: int) -> torch.Tensor:
    """Plain PyTorch K10: (n_brows*bm, d_pad) float32."""
    nsteps, bm, bk = block_vals_pad.shape
    nb = nsteps // kmax
    acc = torch.zeros((nb, bm, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    ids = torch.arange(nb, device=x.device)
    mxu_trips(acc, ids, ids * (kmax * bm * bk), ids * kmax,
              torch.full_like(ids, kmax), block_cols_pad,
              block_vals_pad.reshape(-1), x, bm=bm, bk=bk)
    return acc.reshape(nb * bm, x.shape[1])


def spmm_bcsr(block_cols_pad, block_vals_pad, x, *,
              kmax: int) -> torch.Tensor:
    """Y (n_brows*bm, d_pad) = blocked-A · X.

    block_cols_pad : (n_brows * kmax,) int32 — block-column per step
                     (padding steps -> 0)
    block_vals_pad : (n_brows * kmax, bm, bk) float32 — zero blocks on
                     padding
    x              : (n_pad, d_pad) float32, n_pad % bk == 0

    CPU tensors run :func:`spmm_bcsr_plain`; CUDA tensors launch
    ``csrc/spmm_bcsr.cu`` once (counted in ``spmm_bcsr.launches``).
    """
    _check(block_cols_pad, block_vals_pad, x, kmax)
    if x.device.type == "cpu":
        return spmm_bcsr_plain(block_cols_pad, block_vals_pad, x, kmax=kmax)
    nsteps, bm, bk = block_vals_pad.shape
    n_brows, d_pad = nsteps // kmax, x.shape[1]
    y = torch.empty((n_brows * bm, d_pad), dtype=torch.float32,
                    device=x.device)
    if n_brows == 0 or d_pad == 0:
        return y
    lib = _build.load("spmm_bcsr", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr_launch(
            block_cols_pad.data_ptr(), block_vals_pad.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_brows, bm, bk, kmax, d_pad,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_bcsr launch failed with CUDA error {err}")
    spmm_bcsr.launches += 1
    return y


spmm_bcsr.launches = 0


def _pad_to_kmax(b):
    """``spmm_bcsr``'s operands for a ``BCSRMatrix``: every block-row
    padded to the global ``kmax`` with zero blocks at block-column 0,
    after its own blocks, as ``(block_cols_pad, block_vals_pad, kmax)``
    on the values' device."""
    counts = np.diff(b.block_row_ptr)
    kmax = max(int(counts.max(initial=0)), 1)
    step = np.arange(b.nblocks) - np.repeat(b.block_row_ptr[:-1], counts)
    slot = np.repeat(np.arange(b.n_block_rows), counts) * kmax + step
    cols = np.zeros(b.n_block_rows * kmax, np.int32)
    cols[slot] = b.block_cols
    dev = b.block_vals.device
    vals = torch.zeros((b.n_block_rows * kmax, b.bm, b.bk),
                       dtype=torch.float32, device=dev)
    vals[torch.from_numpy(slot).to(dev)] = b.block_vals.float()
    return torch.from_numpy(cols).to(dev), vals, kmax
