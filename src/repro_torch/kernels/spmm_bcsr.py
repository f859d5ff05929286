"""K10: the pre-fusion block-CSR SpMM, ``Y (n_brows*bm, d_pad) = A · X``.

Replaces the TPU kernel ``src/repro/kernels/spmm_bcsr.py`` ::
``spmm_bcsr`` (``_kernel``) with the hand-written CUDA kernel
``csrc/spmm_bcsr.cu``.  It is the pre-fusion MXU micro-oracle: every
block-row holds ``kmax`` (bm x bk) blocks, padded with zero blocks that
point at block-column 0, and step ``k`` of block-row ``i`` adds
``block_vals_pad[i*kmax + k] @ X[bc*bk : (bc+1)*bk]`` with
``bc = block_cols_pad[i*kmax + k]``.

What bounds it on an H100: bytes, as K2.  Block-row ``i`` is one MXU
descriptor of K2's, with the implicit table :func:`bcsr_tables` writes
out (tag 1, values from ``i*kmax*bm*bk``, block-columns from
``i*kmax``, ``kmax`` steps).  The kernel takes one of two routes,
:func:`ring_route`, both hand-written and chosen before the launch:
where the width is whole 128-column tiles and the ring fits a CTA,
K2's warp-specialised gather ring (``csrc/spmm_gather_ring.cuh``, its
``BlockRows`` source computing each descriptor from its index, with
stages of several block steps at small bk, :func:`ring_geometry`), X
through ``aligned16``; elsewhere one CTA per (block-row, column tile)
walking its steps with K2's block trip (``csrc/spmm_trips.cuh``), in
CTAs of :func:`narrow_threads` threads.  Both compute in
fp32 with K2's roundings (no TF32, no tensor cores), so K10 equals K2
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
from ..distributed import aligned16
from .spmm_bcsr_fused import mxu_trips
from .spmm_ell_fused import (COL_TILE, MAX_SHARED_BYTES, MBARRIER_BYTES,
                             RING_SLOTS, STAGE_ROWS, SUPPORTED_BM, X_STAGES,
                             check_placement)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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


def ring_geometry(*, bm: int, bk: int) -> dict:
    """A stage of K10's ring: ``steps`` consecutive block steps of one
    block-row (``max(1, 8 // bk)``, so a small bk keeps as many X rows a
    stage in flight as bk = 8), their ``rows = steps * bk`` X rows and
    their ``panel = steps * bm * bk`` values
    (``csrc/spmm_gather_ring.cuh::block_steps``)."""
    steps = STAGE_ROWS // bk if bk < STAGE_ROWS else 1
    return dict(steps=steps, rows=steps * bk, panel=steps * bm * bk)


def ring_bytes(*, bm: int, bk: int) -> int:
    """Dynamic shared memory of one K10 ring CTA: a full and an empty
    mbarrier for each of the ring's slots (unused) and stages, and the
    stages, each its X rows of one column tile and its value panels in
    whole 16-byte units (``BlockRows::smem`` computes the same)."""
    g = ring_geometry(bm=bm, bk=bk)
    barriers = 2 * (RING_SLOTS + X_STAGES) * MBARRIER_BYTES
    return barriers + X_STAGES * (g["rows"] * COL_TILE
                                  + -(-g["panel"] // 4) * 4) * 4


def narrow_threads(d_pad: int) -> int:
    """Threads a CTA of the one-CTA-a-block-row body takes: whole warps
    covering the width below 128 columns, else one a column of a
    128-column tile."""
    return min(COL_TILE, -(-d_pad // 32) * 32)


def ring_route(d_pad: int, *, bm: int, bk: int) -> bool:
    """Whether K10 runs the gather ring: whole 128-column tiles and a
    ring (:func:`ring_bytes`) within a CTA's shared memory; otherwise
    the one-CTA-a-block-row body."""
    return (d_pad > 0 and d_pad % COL_TILE == 0
            and ring_bytes(bm=bm, bk=bk) <= MAX_SHARED_BYTES)


def bcsr_tables(n_brows: int, kmax: int, *, bm: int, bk: int, device):
    """K10's descriptor table, int32 on ``device``, as K2's tables:
    block-row ``i`` is an MXU descriptor (tag 1) with its value panels
    from ``i*kmax*bm*bk``, its block-columns from ``i*kmax`` and
    ``kmax`` steps.  The ring computes the same from ``i``."""
    ids = torch.arange(n_brows, dtype=torch.int32, device=device)
    return (torch.ones_like(ids), ids * (kmax * bm * bk), ids * kmax,
            torch.full_like(ids, kmax))


def spmm_bcsr_plain(block_cols_pad, block_vals_pad, x, *,
                    kmax: int) -> torch.Tensor:
    """Plain PyTorch K10: (n_brows*bm, d_pad) float32, K2's plain block
    trip over :func:`bcsr_tables`."""
    nsteps, bm, bk = block_vals_pad.shape
    nb = nsteps // kmax
    acc = torch.zeros((nb, bm, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    _, off, coff, L = (t.long() for t in bcsr_tables(nb, kmax, bm=bm, bk=bk,
                                                     device=x.device))
    mxu_trips(acc, torch.arange(nb, device=x.device), off, coff, L,
              block_cols_pad, block_vals_pad.reshape(-1), x, bm=bm, bk=bk)
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
    ``csrc/spmm_bcsr.cu`` once (counted in ``spmm_bcsr.launches``): K2's
    gather ring where :func:`ring_route` says so, with X through
    ``aligned16``, else the one-CTA-a-block-row body.
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
    ring = ring_route(d_pad, bm=bm, bk=bk)
    if ring:
        x = aligned16(x)
    lib = _build.load("spmm_bcsr", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr_launch(
            block_cols_pad.data_ptr(), block_vals_pad.data_ptr(),
            x.data_ptr(), y.data_ptr(), n_brows, bm, bk, kmax, d_pad,
            0 if ring else narrow_threads(d_pad),
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
