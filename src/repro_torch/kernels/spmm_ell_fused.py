"""K1: the fused multi-segment CCM SpMM — the whole plan in ONE launch.

Replaces the TPU kernel ``src/repro/kernels/spmm_ell_fused.py`` ::
``spmm_ell_fused`` (``_kernel``, resident staging) with the hand-written
CUDA kernel ``csrc/spmm_ell_fused.cu``.  The planner packs every ELL
segment into one flat slot stream with a per-row-block descriptor table
(``blk_off``, ``blk_L``); one launch walks it, one CTA per (merged trip,
128-column tile), and writes workspace rows that the caller maps back
to output order with one ``inv_perm`` gather.

What bounds it on an H100: bytes.  Each slot gathers a whole X row, and
for a large X most of those rows miss the 50 MB L2, so the floor is
about ``S * d_pad * 4`` bytes over 3.35 TB/s.  The kernel spends one
thread per output column, so a gathered row is one coalesced read per
CTA, keeps a descriptor's ``bm`` row accumulators in registers, and
writes each output row once (the note in the ``.cu`` file has more).

:func:`spmm_ell_fused_plain` is the plain PyTorch version: it walks the
same descriptor stream in the same per-row order, vectorised over the
descriptors, rows and columns of each trip step.  The wrapper runs it
for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

SUPPORTED_BM = (1, 2, 4, 8, 16)


def check_tables(tables, cols_flat, vals_flat, x, *, bm: int, mw: int):
    """Validate the operands a fused kernel reads, before any pointer is
    taken: one device, int32 1-D descriptor tables of one length, an
    int32 column stream, f32 slot values, a 2-D f32 X, all contiguous,
    and a descriptor count the merge width divides."""
    dev = x.device
    for name, t in [*tables.items(), ("cols_flat", cols_flat)]:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} with shape {tuple(t.shape)}")
    if vals_flat.dtype != torch.float32 or vals_flat.dim() != 1:
        raise ValueError("vals_flat must be a 1-D float32 tensor")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor")
    operands = {**tables, "cols_flat": cols_flat, "vals_flat": vals_flat,
                "x": x}
    for name, t in operands.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sizes = {t.shape[0] for t in tables.values()}
    if len(sizes) != 1:
        raise ValueError(f"descriptor tables differ in length: {sizes}")
    if bm not in SUPPORTED_BM:
        raise ValueError(f"bm must be one of {SUPPORTED_BM}, got {bm}")
    if mw < 1 or sizes.pop() % mw:
        raise ValueError(f"the merge width {mw} must divide the "
                         f"descriptor count")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must be on the CPU or a CUDA device, "
                         f"got {dev}")


def vpu_trips(acc, sel, off, coff, L, cols_flat, vals_flat, x, *, bm: int):
    """Run the gather-FMA trips of the descriptors ``sel`` into ``acc``
    (B, bm, d_pad), step by step: at step ``nz`` every descriptor with
    ``L > nz`` adds ``vals[off + r*L + nz] * x[cols[coff + r*L + nz]]``
    to row ``r`` — the kernels' per-row order, with one rounding for the
    product and one for the sum."""
    if sel.numel() == 0:
        return
    rr = torch.arange(bm, device=x.device)
    for nz in range(int(L[sel].max())):
        b = sel[L[sel] > nz]
        step = rr[None, :] * L[b, None] + nz                 # (nb, bm)
        v = vals_flat[off[b, None] + step]
        k = cols_flat[coff[b, None] + step].long()
        acc[b] = acc[b] + v[..., None] * x[k]


def _long(*tables):
    return [t.long() for t in tables]


def spmm_ell_fused_plain(blk_off, blk_L, cols_flat, vals_flat, x, *,
                         bm: int = 8, mw: int = 1) -> torch.Tensor:
    """Plain PyTorch K1: (B*bm, d_pad) workspace rows.  ``mw`` only
    groups descriptors into launches; each row's result does not depend
    on it, so the plain version accepts it and ignores it."""
    del mw
    off, L = _long(blk_off, blk_L)
    acc = torch.zeros((off.shape[0], bm, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    vpu_trips(acc, torch.arange(off.shape[0], device=x.device), off, off, L,
              cols_flat, vals_flat, x, bm=bm)
    return acc.reshape(-1, x.shape[1])


def spmm_ell_fused(blk_off, blk_L, cols_flat, vals_flat, x, *,
                   bm: int = 8, mw: int = 1) -> torch.Tensor:
    """Compute ALL plan segments: Y_ws (B*bm, d_pad) = plan · X.

    blk_off   : (B,) int32 — first slot of each row-block (descriptor)
    blk_L     : (B,) int32 — padded nnz/row of each row-block
    cols_flat : (S,) int32 — slot -> X row
    vals_flat : (S,) float32 — slot values, zero on padding slots
    x         : (n, d_pad) float32
    mw        : CGCM merge width — descriptors per CTA; divides B

    CPU tensors run :func:`spmm_ell_fused_plain`; CUDA tensors launch
    ``csrc/spmm_ell_fused.cu`` once (counted in ``spmm_ell_fused.launches``).
    """
    check_tables({"blk_off": blk_off, "blk_L": blk_L}, cols_flat, vals_flat,
                 x, bm=bm, mw=mw)
    if x.device.type == "cpu":
        return spmm_ell_fused_plain(blk_off, blk_L, cols_flat, vals_flat, x,
                                    bm=bm, mw=mw)
    num_blocks = blk_off.shape[0]
    d_pad = x.shape[1]
    y = torch.empty((num_blocks * bm, d_pad), dtype=torch.float32,
                    device=x.device)
    if num_blocks == 0:
        return y
    lib = _build.load("spmm_ell_fused", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_ell_fused_launch(
            blk_off.data_ptr(), blk_L.data_ptr(), cols_flat.data_ptr(),
            vals_flat.data_ptr(), x.data_ptr(), y.data_ptr(),
            num_blocks // mw, bm, mw, d_pad,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_ell_fused launch failed with CUDA "
                           f"error {err}")
    spmm_ell_fused.launches += 1
    return y


spmm_ell_fused.launches = 0
