"""K2: the fused mixed VPU/MXU SpMM — BCSR block-rows folded into the
single-launch descriptor stream.

Replaces the TPU kernel ``src/repro/kernels/spmm_bcsr_fused.py`` ::
``spmm_bcsr_fused`` (``_kernel``, resident staging) with the hand-written
CUDA kernel ``csrc/spmm_bcsr_fused.cu``.  Every descriptor carries a tag:

  VPU (tag 0): K1's gather-FMA trips, the column entries read at
      ``coff + r*L + nz`` (the column stream is not slot-parallel once
      MXU block-rows join it).
  MXU (tag 1): ``L`` block steps; step ``k`` multiplies the (bm, bk)
      value panel at ``vals[off + k*bm*bk:]`` by the (bk, d_pad) X panel
      of block-column ``cols[coff + k]`` and adds it to the block.

What bounds it on an H100: bytes.  On the block-structured instances
the planner tags MXU, neighbouring block-rows share X panels that L2
keeps, so the floor is X once, the value panels once and the output once
over 3.35 TB/s.  The kernel loads each X panel row once per step and
reuses it for all ``bm`` rows from registers, in full fp32 FFMA (the
reference computes fp32 × fp32 → fp32; tensor cores have no IEEE fp32
mode); the tag branch is per descriptor, uniform across the CTA.

:func:`spmm_bcsr_fused_plain` is the plain PyTorch version, walking the
same stream in the same per-row order, vectorised over the descriptors,
rows and columns of each step.  The wrapper runs it for CPU tensors;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .spmm_ell_fused import _long, check_tables, vpu_trips

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def mxu_trips(acc, sel, off, coff, L, cols_flat, vals_flat, x, *, bm: int,
              bk: int):
    """Run the block steps of the MXU descriptors ``sel`` into ``acc``:
    at step ``k`` every descriptor with ``L > k`` adds
    ``a(bm, bk) @ x[bc*bk : bc*bk + bk]`` with ``bc = cols[coff + k]``."""
    if sel.numel() == 0:
        return
    panel = torch.arange(bm * bk, device=x.device)
    xrows = torch.arange(bk, device=x.device)
    for k in range(int(L[sel].max())):
        b = sel[L[sel] > k]
        a = vals_flat[off[b, None] + k * bm * bk + panel].view(-1, bm, bk)
        bc = cols_flat[coff[b] + k].long()
        xp = x[bc[:, None] * bk + xrows]                     # (nb, bk, d)
        acc[b] = acc[b] + torch.bmm(a, xp)


def spmm_bcsr_fused_plain(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                          vals_flat, x, *, bm: int = 8, bk: int = 8,
                          mw: int = 1) -> torch.Tensor:
    """Plain PyTorch K2: (B*bm, d_pad) workspace rows.  ``mw`` only
    groups descriptors into launches and does not change any row."""
    del mw
    tag, off, coff, L = _long(blk_tag, blk_off, blk_coff, blk_L)
    acc = torch.zeros((tag.shape[0], bm, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    ids = torch.arange(tag.shape[0], device=x.device)
    vpu_trips(acc, ids[tag == 0], off, coff, L, cols_flat, vals_flat, x,
              bm=bm)
    mxu_trips(acc, ids[tag != 0], off, coff, L, cols_flat, vals_flat, x,
              bm=bm, bk=bk)
    return acc.reshape(-1, x.shape[1])


def spmm_bcsr_fused(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                    vals_flat, x, *, bm: int = 8, bk: int = 8,
                    mw: int = 1) -> torch.Tensor:
    """Compute the WHOLE mixed plan: Y_ws (B*bm, d_pad) = plan · X.

    blk_tag   : (B,) int32 — 0 = VPU ELL block, 1 = MXU block-row
    blk_off   : (B,) int32 — first slot of each block in vals_flat
    blk_coff  : (B,) int32 — first entry of each block in cols_flat
    blk_L     : (B,) int32 — trips: padded nnz/row (VPU) or K (MXU)
    cols_flat : (Sc,) int32 — X row per slot (VPU) / block-column (MXU)
    vals_flat : (S,) float32 — slot values; MXU panels flattened (K,bm,bk)
    x         : (n_pad, d_pad) float32 — rows padded to a bk multiple
    mw        : CGCM merge width — descriptors per CTA; divides B

    CPU tensors run :func:`spmm_bcsr_fused_plain`; CUDA tensors launch
    ``csrc/spmm_bcsr_fused.cu`` once (counted in
    ``spmm_bcsr_fused.launches``).
    """
    check_tables({"blk_tag": blk_tag, "blk_off": blk_off,
                  "blk_coff": blk_coff, "blk_L": blk_L}, cols_flat,
                 vals_flat, x, bm=bm, mw=mw)
    if bk < 1 or x.shape[0] % bk:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"bk={bk}")
    if x.device.type == "cpu":
        return spmm_bcsr_fused_plain(blk_tag, blk_off, blk_coff, blk_L,
                                     cols_flat, vals_flat, x, bm=bm, bk=bk,
                                     mw=mw)
    num_blocks = blk_tag.shape[0]
    d_pad = x.shape[1]
    y = torch.empty((num_blocks * bm, d_pad), dtype=torch.float32,
                    device=x.device)
    if num_blocks == 0:
        return y
    lib = _build.load("spmm_bcsr_fused", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr_fused_launch(
            blk_tag.data_ptr(), blk_off.data_ptr(), blk_coff.data_ptr(),
            blk_L.data_ptr(), cols_flat.data_ptr(), vals_flat.data_ptr(),
            x.data_ptr(), y.data_ptr(), num_blocks // mw, bm, bk, mw, d_pad,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_bcsr_fused launch failed with CUDA "
                           f"error {err}")
    spmm_bcsr_fused.launches += 1
    return y


spmm_bcsr_fused.launches = 0
