"""K2 and K4: the fused mixed VPU/MXU SpMM — BCSR block-rows folded into
the single-launch descriptor stream, resident (K2) or staged (K4).

Replaces the TPU kernel ``src/repro/kernels/spmm_bcsr_fused.py`` ::
``spmm_bcsr_fused`` (``_kernel``, resident staging) with the hand-written
CUDA kernel ``csrc/spmm_bcsr_fused.cu``.  Every descriptor carries a tag:

  VPU (tag 0): K1's gather-FMA trips, the column entries read at
      ``coff + r*L + nz`` (the column stream is not slot-parallel once
      MXU block-rows join it).
  MXU (tag 1): ``L`` block steps; step ``k`` multiplies the (bm, bk)
      value panel at ``vals[off + k*bm*bk:]`` by the (bk, d_pad) X panel
      of block-column ``cols[coff + k]`` and adds it to the block.

What bounds it on an H100: bytes.  A VPU step gathers ``bm`` X rows
that mostly miss L2 on a large random graph; on the block-structured
instances the planner tags MXU, neighbouring block-rows share X panels
that L2 keeps, so the floor is X once, the value panels once and the
output once over 3.35 TB/s.  K2 is K4's warp-specialised CTA on
``csrc/spmm_gather_ring.cuh`` with the resident descriptor source: a
producer warp reads each step's column indices from global memory and
copies the step's X rows (and an MXU step's value panel) into an
``X_STAGES``-stage ring ahead of four consumer warps, which read the
descriptor tables and a VPU step's values where they lie and add the
steps in full fp32 (the reference
computes fp32 × fp32 → fp32; tensor cores have no IEEE fp32 mode).  It
has no slot ring and no chunked walk; :func:`ring_bytes` is its shared
memory.  The tag branch is per descriptor, uniform across the CTA.

:func:`spmm_bcsr_fused_plain` is the plain PyTorch version, walking the
same stream in the same per-row order, vectorised over the descriptors,
rows and columns of each step.  The wrapper runs it for CPU tensors;
for CUDA tensors it launches the kernel or raises.  Kernel and plain
version add the same products in the same order, so they agree bit for
bit.

K4, :func:`spmm_bcsr_fused_staged`, replaces the TPU kernel
``spmm_bcsr_fused_staged`` (``_staged_kernel``, ``staging="dma"``) with
``csrc/spmm_bcsr_fused_staged.cu``: the same CTA with the slot source —
the producer warp also fills the ring of slot and column windows (bulk
asynchronous copies, chunks for a window over the slot's capacity)
before copying each VPU step's ``bm`` gathered rows and each MXU step's
(bk, 128) panel into the X ring, as the reference's ``xgbuf``/``xpbuf``.
Bound by bytes like K2; the sums run in K2's order, so K4 is
bit-identical to K2.
:func:`spmm_bcsr_fused_staged_plain` walks the same windows and chunks
on the CPU.

K8 for this backend, :func:`spmm_bcsr_fused_sharded`, launches K2 or K4
once per chip of a ``ChipMesh`` (``distributed.run_on_chips``); under
``x_sharding="rows"`` each chip's X is its compact (T*bk, d_pad)
workspace from the exact-panel exchange.
"""
from __future__ import annotations

import ctypes

import torch

from ..distributed import check_on_mesh, run_on_chips, sharded_x
from . import _build
from .spmm_ell_fused import (COL_TILE, MAX_SHARED_BYTES, MBARRIER_BYTES,
                             RING_SLOTS, X_STAGES, _long, check_staged,
                             check_tables, staged_plain, staging_geometry,
                             vpu_trips)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_STAGED_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])


def mxu_trips(acc, sel, off, coff, L, cols_flat, vals_flat, x, *, bm: int,
              bk: int):
    """Run the block steps of the MXU descriptors ``sel`` into ``acc``:
    at step ``k`` every descriptor with ``L > k`` adds
    ``t = a(bm, bk) @ x[bc*bk : bc*bk + bk]`` with ``bc = cols[coff + k]``,
    ``t`` summed over the panel's columns in order, one rounding for each
    product and each sum — the kernels' order, so their MXU trips match
    this bit for bit."""
    if sel.numel() == 0:
        return
    panel = torch.arange(bm * bk, device=x.device)
    xrows = torch.arange(bk, device=x.device)
    for k in range(int(L[sel].max())):
        b = sel[L[sel] > k]
        a = vals_flat[off[b, None] + k * bm * bk + panel].view(-1, bm, bk)
        bc = cols_flat[coff[b] + k].long()
        xp = x[bc[:, None] * bk + xrows]                     # (nb, bk, d)
        t = a[:, :, 0, None] * xp[:, None, 0]
        for c in range(1, bk):
            t = t + a[:, :, c, None] * xp[:, None, c]
        acc[b] = acc[b] + t


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


def _check_rows(x, bk: int) -> None:
    if bk < 1 or x.shape[0] % bk:
        raise ValueError(f"x has {x.shape[0]} rows, not a multiple of "
                         f"bk={bk}")


def ring_bytes(*, bm: int, bk: int) -> int:
    """Dynamic shared memory of one K2 CTA: the gather ring's barriers
    (a full and an empty mbarrier for each of the :data:`RING_SLOTS`
    slots, unused by the resident source, and each of the
    :data:`X_STAGES` stages) and the X stages, each ``max(bm, bk)`` rows
    by one column tile plus an MXU step's ``bm * bk`` value panel
    rounded up to whole 16-byte units
    (``csrc/spmm_gather_ring.cuh::resident_ring_bytes`` computes the
    same)."""
    barriers = 2 * (RING_SLOTS + X_STAGES) * MBARRIER_BYTES
    stage = max(bm, bk) * COL_TILE + -(-bm * bk // 4) * 4
    return barriers + X_STAGES * stage * 4


def check_resident(x, *, bm: int, bk: int) -> None:
    """What a K2 launch needs beyond :func:`check_tables`: whole column
    tiles, an X ring that fits a CTA, and (on the card) X on a 16-byte
    boundary for the copies."""
    if x.shape[1] % COL_TILE:
        raise ValueError(f"spmm_bcsr_fused takes x with a multiple of "
                         f"{COL_TILE} columns, got {x.shape[1]}")
    nbytes = ring_bytes(bm=bm, bk=bk)
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"an X ring of {nbytes} bytes exceeds the "
                         f"{MAX_SHARED_BYTES} bytes a CTA may use")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary for the "
                         "kernel's copies")


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
    x         : (n_pad, d_pad) float32 — rows padded to a bk multiple,
                d_pad a multiple of 128
    mw        : CGCM merge width — descriptors per CTA; divides B

    CPU tensors run :func:`spmm_bcsr_fused_plain`; CUDA tensors launch
    ``csrc/spmm_bcsr_fused.cu`` once (counted in
    ``spmm_bcsr_fused.launches``).
    """
    check_tables({"blk_tag": blk_tag, "blk_off": blk_off,
                  "blk_coff": blk_coff, "blk_L": blk_L}, cols_flat,
                 vals_flat, x, bm=bm, mw=mw)
    _check_rows(x, bk)
    check_resident(x, bm=bm, bk=bk)
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


def spmm_bcsr_fused_staged_plain(blk_tag, blk_off, blk_coff, blk_L,
                                 cols_flat, vals_flat, x, *, span: int,
                                 cspan: int, bm: int = 8, bk: int = 8,
                                 mw: int = 1, cap=None) -> torch.Tensor:
    """Plain PyTorch K4: (B*bm, d_pad) workspace rows, through the same
    windows and chunks as the kernel (``spmm_ell_fused.staged_plain``)."""
    tag, off, coff, L = _long(blk_tag, blk_off, blk_coff, blk_L)
    return staged_plain(tag, off, coff, L, cols_flat, vals_flat, x, bm=bm,
                        bk=bk, mw=mw, span=span, cspan=cspan, cap=cap,
                        mxu_steps=mxu_trips)


def spmm_bcsr_fused_staged(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                           vals_flat, x, *, span: int, cspan: int,
                           bm: int = 8, bk: int = 8, mw: int = 1,
                           cap=None) -> torch.Tensor:
    """The staged mixed dispatch (DESIGN.md §7.7) — :func:`spmm_bcsr_fused`'s
    contract and bit-identical output.  ``span``/``cspan`` are the
    workspace's ``max_span``/``max_cspan`` (see
    ``spmm_ell_fused.spmm_ell_fused_staged``); ``x`` has a multiple of
    128 columns.

    CPU tensors run :func:`spmm_bcsr_fused_staged_plain`; CUDA tensors
    launch ``csrc/spmm_bcsr_fused_staged.cu`` once (counted in
    ``spmm_bcsr_fused_staged.launches``).
    """
    check_tables({"blk_tag": blk_tag, "blk_off": blk_off,
                  "blk_coff": blk_coff, "blk_L": blk_L}, cols_flat,
                 vals_flat, x, bm=bm, mw=mw)
    _check_rows(x, bk)
    c, ch, kc = staging_geometry(span, cspan, bm=bm, bk=bk, cap=cap)
    check_staged(x, cols_flat, vals_flat, c=c, bm=bm, bk=bk)
    if x.device.type == "cpu":
        return spmm_bcsr_fused_staged_plain(
            blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat, x,
            span=span, cspan=cspan, bm=bm, bk=bk, mw=mw, cap=cap)
    num_blocks = blk_tag.shape[0]
    d_pad = x.shape[1]
    y = torch.empty((num_blocks * bm, d_pad), dtype=torch.float32,
                    device=x.device)
    if num_blocks == 0:
        return y
    lib = _build.load("spmm_bcsr_fused_staged", _STAGED_ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_bcsr_fused_staged_launch(
            blk_tag.data_ptr(), blk_off.data_ptr(), blk_coff.data_ptr(),
            blk_L.data_ptr(), cols_flat.data_ptr(), vals_flat.data_ptr(),
            x.data_ptr(), y.data_ptr(), num_blocks // mw, bm, bk, mw, d_pad,
            c, ch, kc, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_bcsr_fused_staged launch failed with CUDA "
                           f"error {err}")
    spmm_bcsr_fused_staged.launches += 1
    return y


spmm_bcsr_fused_staged.launches = 0


# -- K8: the sharded dispatch, one launch per chip ---------------------------

def _bcsr_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat, x,
                  *, mesh, bm, bk, mw, staging, span, cspan, x_sharding,
                  x_send, x_recv, cap, plain: bool):
    check_on_mesh(mesh, blk_tag=blk_tag, blk_off=blk_off, blk_coff=blk_coff,
                  blk_L=blk_L, cols_flat=cols_flat, vals_flat=vals_flat, x=x,
                  x_send=x_send, x_recv=x_recv)
    if staging == "dma":
        kernel = (spmm_bcsr_fused_staged_plain if plain
                  else spmm_bcsr_fused_staged)
    else:
        kernel = spmm_bcsr_fused_plain if plain else spmm_bcsr_fused
    xs = sharded_x(x, mesh, x_sharding, x_send, x_recv)
    return run_on_chips(kernel, (blk_tag, blk_off, blk_coff, blk_L,
                                 cols_flat, vals_flat),
                        [(xc,) for xc in xs], mesh=mesh, staging=staging,
                        span=span, cspan=cspan, cap=cap,
                        knobs=dict(bm=bm, bk=bk, mw=mw),
                        counter=None if plain else spmm_bcsr_fused_sharded)


def spmm_bcsr_fused_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                            vals_flat, x, *, mesh, bm: int = 8, bk: int = 8,
                            mw: int = 1, staging: str = "resident", span=0,
                            cspan=0, x_sharding: str = "replicated",
                            x_send=None, x_recv=None,
                            cap=None) -> torch.Tensor:
    """K8 for ``pallas_bcsr``: one K2 (``resident``) or K4 (``dma``)
    launch per chip of ``mesh``, each on its chip's device — the
    contract of ``spmm_ell_fused.spmm_ell_fused_sharded`` with the mixed
    plan's (C, B) ``blk_tag``/``blk_coff`` tables.  ``x`` is the
    replicated (n_pad, d_pad) operand or, under ``x_sharding="rows"``,
    the stacked (C, P, bk, d_pad) owned strips, from which the exchange
    builds each chip's compact (T*bk, d_pad) workspace.  Returns (C,
    B*bm, d_pad) in chip order; each chip's launch also counts in
    ``spmm_bcsr_fused_sharded.launches``."""
    return _bcsr_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                         vals_flat, x, mesh=mesh, bm=bm, bk=bk, mw=mw,
                         staging=staging, span=span, cspan=cspan,
                         x_sharding=x_sharding, x_send=x_send, x_recv=x_recv,
                         cap=cap, plain=False)


spmm_bcsr_fused_sharded.launches = 0


def spmm_bcsr_fused_sharded_plain(blk_tag, blk_off, blk_coff, blk_L,
                                  cols_flat, vals_flat, x, *, mesh,
                                  bm: int = 8, bk: int = 8, mw: int = 1,
                                  staging: str = "resident", span=0, cspan=0,
                                  x_sharding: str = "replicated",
                                  x_send=None, x_recv=None,
                                  cap=None) -> torch.Tensor:
    """Plain PyTorch K8 for ``pallas_bcsr``: the same chip loop and
    exchange through :func:`spmm_bcsr_fused_plain` /
    :func:`spmm_bcsr_fused_staged_plain`."""
    return _bcsr_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                         vals_flat, x, mesh=mesh, bm=bm, bk=bk, mw=mw,
                         staging=staging, span=span, cspan=cspan,
                         x_sharding=x_sharding, x_send=x_send, x_recv=x_recv,
                         cap=cap, plain=True)
