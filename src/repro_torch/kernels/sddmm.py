"""K7: the SDDMM, ``dA.vals[p] = <dY[row_p], X[col_p]>``.

Replaces the TPU kernel ``src/repro/kernels/sddmm.py`` :: ``sddmm``
(``_kernel``) with the hand-written CUDA kernel ``csrc/sddmm.cu``: the
structure-restricted gradient of SpMM with respect to the nonzero
values, over a padded list of (row, col) pairs.  Each pair's sum over d
runs in lane tiles of ``dt`` (the widest halving of 512 that divides
``d_pad``, as in the reference); a tile's sum is formed, then added to
the pair's total in tile order.

What bounds it on an H100: bytes.  A pair does ``2*d_pad`` flops on two
gathered rows, and for a large X the X row of most pairs misses L2, so
the honest floor is about one X row per pair over 3.35 TB/s.  Persistent
warps walk runs of 32 consecutive pairs: each warp copies the next
step's X row slices into its own shared-memory ring (``cp.async``, 16
bytes a lane where X allows it) while it reads the current one, keeps
dY in registers while the row stays the same, and adds the 32 pairs'
lane partials in one transposed shuffle butterfly, so each lane stores
one pair's total (``csrc/sddmm.cu`` has more).  Its sums are those of a
warp per pair, bit for bit.

:func:`sddmm_plain` is the plain PyTorch version, the same tiles summed
in the same order; the wrapper runs it for CPU tensors, and for CUDA
tensors it launches the kernel or raises.  :func:`sddmm_csr` is the
reference's entry point on a ``CSRMatrix`` structure, with ``device`` in
place of ``interpret``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..distributed import aligned16
from .ops import DISPATCH_COUNTS, resolve_device
from .spmm_ell_fused import check_placement

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

# bound on the (pairs x d_pad) entries the plain version gathers per
# operand at a time: 2^25 float32, 128 MiB
_PLAIN_CHUNK = 1 << 25

# csrc/sddmm.cu's CTA: RING_WARPS warps, each with RING_STAGES X stages
# of 4 KB (8 KB for 512-wide lane tiles)
RING_WARPS, RING_STAGES = 8, 2


def ring_bytes(nj: int) -> int:
    """Dynamic shared memory of one K7 CTA of the instance with ``nj``
    elements a lane (``csrc/sddmm.cu::smem_bytes`` computes the same)."""
    return RING_WARPS * RING_STAGES * (2048 if nj == 16 else 1024) * 4


def _lane_tile(d_pad: int) -> int:
    from ..core.ccm import kernel_lane_tile   # lazy: core imports kernels
    return kernel_lane_tile(d_pad) if d_pad else 1


def _check(rows_pad, cols_pad, dy, x, T: int) -> None:
    """Validate the kernel's operands before any pointer is taken."""
    for name, t in (("rows_pad", rows_pad), ("cols_pad", cols_pad)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} with shape {tuple(t.shape)}")
    for name, t in (("dy", dy), ("x", x)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor")
    nnz_pad = rows_pad.shape[0]
    if cols_pad.shape[0] != nnz_pad:
        raise ValueError("rows_pad and cols_pad differ in length")
    if T < 1 or nnz_pad % T:
        raise ValueError(f"the pair count {nnz_pad} is not a multiple of "
                         f"T={T}")
    if dy.shape[1] != x.shape[1]:
        raise ValueError(f"dy has {dy.shape[1]} columns, x {x.shape[1]}")
    if nnz_pad and (dy.shape[0] == 0 or x.shape[0] == 0):
        raise ValueError("pairs index into an empty dy or x")
    check_placement({"rows_pad": rows_pad, "cols_pad": cols_pad, "dy": dy},
                    x)


def sddmm_plain(rows_pad, cols_pad, dy, x, *, T: int = 128) -> torch.Tensor:
    """Plain PyTorch K7: (nnz_pad,) float32.  ``T`` only groups pairs
    into programs in the reference and does not change any sum."""
    del T
    d_pad = x.shape[1]
    dt = _lane_tile(d_pad)
    out = torch.zeros(rows_pad.shape[0], dtype=torch.float32,
                      device=x.device)
    step = max(1, _PLAIN_CHUNK // max(d_pad, 1))
    for p0 in range(0, rows_pad.shape[0], step):
        r = rows_pad[p0:p0 + step].long()
        c = cols_pad[p0:p0 + step].long()
        acc = out[p0:p0 + step]
        for t0 in range(0, d_pad, dt):
            acc += (dy[r, t0:t0 + dt] * x[c, t0:t0 + dt]).sum(-1)
    return out


def sddmm(rows_pad, cols_pad, dy, x, *, T: int = 128) -> torch.Tensor:
    """dvals (nnz_pad,) float32 for the padded pairs.

    rows_pad : (nnz_pad,) int32 — dY row of each pair, nnz_pad % T == 0
    cols_pad : (nnz_pad,) int32 — X row of each pair
    dy       : (m, d_pad) float32
    x        : (n, d_pad) float32

    CPU tensors run :func:`sddmm_plain`; CUDA tensors launch
    ``csrc/sddmm.cu`` once (counted in ``sddmm.launches``).
    """
    _check(rows_pad, cols_pad, dy, x, T)
    if x.device.type == "cpu":
        return sddmm_plain(rows_pad, cols_pad, dy, x, T=T)
    nnz_pad, d_pad = rows_pad.shape[0], x.shape[1]
    out = torch.empty(nnz_pad, dtype=torch.float32, device=x.device)
    if nnz_pad == 0:
        return out
    lib = _build.load("sddmm", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.sddmm_launch(
            rows_pad.data_ptr(), cols_pad.data_ptr(), dy.data_ptr(),
            x.data_ptr(), out.data_ptr(), nnz_pad, d_pad,
            _lane_tile(d_pad), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sddmm launch failed with CUDA error {err}")
    sddmm.launches += 1
    return out


sddmm.launches = 0


def _csr_pairs(a, dy, x, *, T: int = 128, device: str):
    """``sddmm``'s operands for a ``CSRMatrix`` structure: the (row, col)
    pairs in CSR order padded with (0, 0) up to a multiple of ``T``, and
    dY and X in float32 with d padded to the planner's lane tile."""
    from ..core import ccm                    # lazy: core imports kernels
    if dy.dim() != 2 or x.dim() != 2 or dy.shape[1] != x.shape[1]:
        raise ValueError(f"dy and x must be 2-D with one width, got "
                         f"{tuple(dy.shape)} and {tuple(x.shape)}")
    if dy.shape[0] != a.m or x.shape[0] != a.n:
        raise ValueError(f"dy must have {a.m} rows and x {a.n}, got "
                         f"{dy.shape[0]} and {x.shape[0]}")
    for name, t in (("dy", dy), ("x", x)):
        if t.device != torch.device(device):
            raise ValueError(f"{name} is on {t.device}, not on {device}")
    nnz = a.nnz
    nnz_pad = -(-max(nnz, 1) // T) * T
    rows = np.zeros(nnz_pad, np.int32)
    cols = np.zeros(nnz_pad, np.int32)
    rows[:nnz] = np.repeat(np.arange(a.m), a.row_lengths)
    cols[:nnz] = a.col_indices
    d_pad = ccm.plan_d_tiles(dy.shape[1]).d_pad
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(cols).to(device),
            aligned16(ccm.pad_cols(dy.float(), d_pad).contiguous()),
            aligned16(ccm.pad_cols(x.float(), d_pad).contiguous()))


def sddmm_csr(a, dy, x, *, T: int = 128, device=None) -> torch.Tensor:
    """dvals (nnz,) of a ``CSRMatrix`` structure: ``dy`` (m, d) and
    ``x`` (n, d) on the resolved device (``None`` = the CUDA card,
    raising when there is none; ``"cpu"`` runs the plain version).
    Counts one ``DISPATCH_COUNTS["sddmm"]`` per call; an empty structure
    returns an empty result without a launch."""
    device = resolve_device(device)
    operands = _csr_pairs(a, dy, x, T=T, device=device)
    DISPATCH_COUNTS["sddmm"] += 1
    if a.nnz == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return sddmm(*operands, T=T)[:a.nnz]
