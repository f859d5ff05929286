"""K9: one ELL segment, ``Y_seg (R_pad, d_pad) = segment · X``.

Replaces the TPU kernel ``src/repro/kernels/spmm_csr.py`` ::
``spmm_ell_segment`` (``_kernel``) with the hand-written CUDA kernel
``csrc/spmm_ell_segment.cu``.  It is the per-segment micro-oracle of the
fused path: the serving path runs every segment of a plan in one launch
of K1 (``spmm_ell_fused``), and this kernel runs one segment, the most
literal form of the paper's generated loop (Listing 2).  Row ``r`` sums
``vals_pad[r, l] * X[cols_pad[r, l]]`` over its ``L`` padded slots, with
``bm`` rows per row block.  The reference bakes ``L`` into each compiled
kernel; here it is a launch argument.

What bounds it on an H100: bytes, as K1 — one gathered X row per slot.
The kernel is K2's warp-specialised gather ring
(``csrc/spmm_gather_ring.cuh``, VPU steps only, its resident descriptor
source) over the segment's implicit descriptor table, which
:func:`segment_tables` writes out: row block ``i`` starts at slot
``i*bm*L`` and takes ``L`` steps.  So each row's sum, with its two
roundings a step, is K1's.  The ring takes whole 128-column tiles and X
on a 16-byte boundary: the wrapper pads an unplanned width with zero
columns (and drops them from the result) and passes X through
``aligned16``.

:func:`spmm_ell_segment_plain` is the plain PyTorch version, K1's plain
trip over the same table; the wrapper runs it for CPU tensors, and for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..distributed import aligned16
from .spmm_ell_fused import (COL_TILE, SUPPORTED_BM, check_placement,
                             vpu_trips)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_INT32_LIMIT = 2 ** 31


def _check(cols_pad_flat, vals_pad, x, bm: int) -> None:
    """Validate the kernel's operands before any pointer is taken."""
    if cols_pad_flat.dtype != torch.int32 or cols_pad_flat.dim() != 1:
        raise ValueError("cols_pad_flat must be a 1-D int32 tensor")
    if vals_pad.dtype != torch.float32 or vals_pad.dim() != 2:
        raise ValueError("vals_pad must be a 2-D float32 tensor")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor")
    if cols_pad_flat.shape[0] != vals_pad.numel():
        raise ValueError(f"cols_pad_flat has {cols_pad_flat.shape[0]} "
                         f"entries, vals_pad {vals_pad.numel()}")
    if vals_pad.numel() >= _INT32_LIMIT:
        raise ValueError("the segment's slots exceed 32-bit offsets")
    if bm not in SUPPORTED_BM or vals_pad.shape[0] % bm:
        raise ValueError(f"bm must be one of {SUPPORTED_BM} and divide "
                         f"R_pad={vals_pad.shape[0]}, got {bm}")
    if vals_pad.numel() and x.shape[0] == 0:
        raise ValueError("slots index into an empty x")
    check_placement({"cols_pad_flat": cols_pad_flat, "vals_pad": vals_pad},
                    x)


def segment_tables(R_pad: int, L: int, *, bm: int, device):
    """The segment's descriptor table, int32 on ``device``: row block
    ``i``'s first slot ``i*bm*L`` (its column entries start there too)
    and its ``L`` steps."""
    nb = R_pad // bm
    off = torch.arange(nb, dtype=torch.int32, device=device) * (bm * L)
    return off, torch.full((nb,), L, dtype=torch.int32, device=device)


def spmm_ell_segment_plain(cols_pad_flat, vals_pad, x, *,
                           bm: int = 8) -> torch.Tensor:
    """Plain PyTorch K9: (R_pad, d_pad) float32."""
    R_pad, L = vals_pad.shape
    nb = R_pad // bm
    acc = torch.zeros((nb, bm, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    off, steps = (t.long() for t in segment_tables(R_pad, L, bm=bm,
                                                   device=x.device))
    vpu_trips(acc, torch.arange(nb, device=x.device), off, off, steps,
              cols_pad_flat, vals_pad.reshape(-1), x, bm=bm)
    return acc.reshape(R_pad, x.shape[1])


def spmm_ell_segment(cols_pad_flat, vals_pad, x, *,
                     bm: int = 8) -> torch.Tensor:
    """Compute one ELL segment: Y_seg (R_pad, d_pad) = segment · X.

    cols_pad_flat : (R_pad * L,) int32 — X row of each slot, row-major
    vals_pad      : (R_pad, L) float32 — zero on padding slots
    x             : (n, d_pad) float32
    bm            : rows per row block; divides R_pad

    CPU tensors run :func:`spmm_ell_segment_plain`; CUDA tensors launch
    ``csrc/spmm_ell_segment.cu`` once (counted in
    ``spmm_ell_segment.launches``).
    """
    _check(cols_pad_flat, vals_pad, x, bm)
    if x.device.type == "cpu":
        return spmm_ell_segment_plain(cols_pad_flat, vals_pad, x, bm=bm)
    R_pad, L = vals_pad.shape
    d_pad = x.shape[1]
    if R_pad == 0 or d_pad == 0:
        return torch.empty((R_pad, d_pad), dtype=torch.float32,
                           device=x.device)
    # whole column tiles for the ring; the zero columns change no other
    tiles = -(-d_pad // COL_TILE) * COL_TILE
    x_ring = aligned16(torch.nn.functional.pad(x, (0, tiles - d_pad))
                       if tiles != d_pad else x)
    y = torch.empty((R_pad, tiles), dtype=torch.float32, device=x.device)
    off, steps = segment_tables(R_pad, L, bm=bm, device=x.device)
    lib = _build.load("spmm_ell_segment", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_ell_segment_launch(
            off.data_ptr(), steps.data_ptr(), cols_pad_flat.data_ptr(),
            vals_pad.data_ptr(), x_ring.data_ptr(), y.data_ptr(),
            R_pad // bm, bm, tiles, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_ell_segment launch failed with CUDA "
                           f"error {err}")
    spmm_ell_segment.launches += 1
    return y if tiles == d_pad else y[:, :d_pad].contiguous()


spmm_ell_segment.launches = 0
