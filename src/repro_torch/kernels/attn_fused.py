"""K5 and K6: the fused sparse-attention sandwich — SDDMM score, masked
online softmax and S·V in ONE launch over the descriptor stream,
resident (K5) or staged through shared memory (K6).

Replaces the TPU kernels ``src/repro/kernels/attn_fused.py`` ::
``attn_fused`` (``_kernel``, ``_softmax_trip``) with the hand-written CUDA
kernel ``csrc/attn_fused.cu``, and ``attn_fused_staged``
(``_staged_kernel``) with ``csrc/attn_fused_staged.cu``.  The plan is
SpMM's (the same descriptor tables, slot packing and CGCM merging); per
trip step each row scores ``z = q·k[col]`` (the softmax scale already
folded into Q), folds ``p = w·exp(min(z - m_new, 0))`` into a running max
``m``, denominator ``l`` and accumulator ``acc`` rescaled by
``exp(m - m_new)``, and adds ``p·V``; the output is ``acc / l`` (0 where
``l = 0``).  VPU descriptors fold one nonzero per row per step, MXU
descriptors a (bm x bk) block per step with one rescale.

What bounds them on an H100: operations — 2·dh flops of score and 2·dv
of S·V per nonzero in fp32 outside the tensor cores, against 8 bytes of
weight and column — and, on masks with long rows, the carry's chain
through a long descriptor, which one CTA walks step by step.  K5 and K6
run one warp-specialised CTA (``csrc/attn_ring.cuh``) with two
descriptor sources.  A producer warp hands the persistent CTAs their
trips one at a time and gathers every MXU step's K and V panels into a
ring of stages in shared memory; four consumer warps score each (row,
column) pair of a group of MXU steps, or of VPU steps (whose K and V
rows they read in place), in one to four lanes, with a warp
butterfly's order kept, meet once per group on a barrier of their own,
and fold.  K6 (``csrc/attn_fused_staged.cu``) walks the staged items
(``csrc/spmm_staged.cuh``: the weight and column windows, chunks for a
window over the slot; :func:`kv_geometry`, :func:`ring_bytes`).  K5
(``csrc/attn_fused.cu``) reads the descriptor tables and streams where
they lie and walks whole trips, its producer also copying each MXU
step's weight panel into the step's stage; where K6's ring does not fit
a CTA it takes fewer stages, or none (:func:`resident_geometry`,
:func:`resident_ring_bytes`), and it zero-pads a head width that is not
a multiple of 32 (:func:`head_padded`).  Every rounding is the same in
both, so K6 equals K5 bit for bit.  Since they share the CTA, the card
holds each to its plain version and K5 to the parent tree's K5
(``chip_smoke.py --ab-parent``); the CPU tests hold the plain versions
to the reference.

:func:`attn_fused_plain` and :func:`attn_fused_staged_plain` are the
plain PyTorch versions: the same descriptor walk in the reference
kernel's order, vectorised over the descriptors and rows of each step,
the staged one through the same windows and chunks as K6.  The wrappers
run them for CPU tensors; for CUDA tensors they launch the kernel or
raise.  Their score sums run in another order than the kernels' (a warp
butterfly), so the two agree to rounding, not bit for bit.

K8 for attention, :func:`attn_fused_sharded`, launches K5 or K6 once per
chip of a ``ChipMesh`` with that chip's Q rows in workspace order and
K/V replicated to its device (``distributed.run_on_chips``).
"""
from __future__ import annotations

import ctypes

import torch

from ..distributed import (aligned16, check_on_mesh, place_on_chips,
                           run_on_chips)
from . import _build
from .spmm_bcsr_fused import _check_rows
from .spmm_ell_fused import (_INT_FILL, COL_TILE, MAX_SHARED_BYTES, _long,
                             _windows, check_tables, fitting_buffers,
                             staged_walk, staging_geometry)

_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 2)
_STAGED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                    + [ctypes.c_void_p] * 2)

NEG = -1e30         # finite "masked" score, the reference's _NEG
MAX_BK = 32         # an MXU block's width fits one warp's lanes


# K6's rings (csrc/attn_fused_staged.cu): window slots, each with a
# 32-byte record of its item, the K/V ring's rows (stages x rows a stage)
# and its most stages, each slot and stage with a full and an empty
# 8-byte mbarrier; and the (row, step) pairs of a VPU group
WIN_SLOTS = 2
ITEM_BYTES = 32
KV_ROWS = 32
KV_MAX_STAGES = 16
VPU_PAIRS = 32


def _pow2_floor(v: int) -> int:
    return 1 << (max(int(v), 1).bit_length() - 1)


def _groups(*, bm: int, bk: int, stages: int) -> dict:
    """The VPU and MXU groups and the buffer rows of a CTA whose ring has
    ``stages`` stages (``csrc/attn_ring.cuh::set_groups``)."""
    group = _pow2_floor(min(max(VPU_PAIRS // bm, 1), 32))
    G = 1 << (bk - 1).bit_length()
    mgroup = _pow2_floor(max(min(COL_TILE // (bm * G), 32 // G,
                                 stages // 2), 1))
    pw = -(-max(group, mgroup * bk, 2 * mgroup) // 4) * 4
    return dict(group=group, mgroup=mgroup, pw=pw)


def kv_geometry(*, bm: int, bk: int, dh_pad: int) -> dict:
    """K6's K/V ring (``csrc/attn_ring.cuh::geometry`` computes the
    same): ``rows`` K rows and as many V-tile rows a stage (an MXU
    step's panels), ``bk``; ``qstride``, the floats between K
    (and Q) rows, ``dh_pad + 4``; ``stage``, the floats of a stage,
    padded so that a stage starts 4 banks after the one before;
    ``stages``, the stages (a power of two, about :data:`KV_ROWS` rows
    in all, 2 to :data:`KV_MAX_STAGES`); ``group``, the VPU steps scored
    together (a power of two, :data:`VPU_PAIRS` ``/ bm``, 1 to 32);
    ``mgroup``, the MXU steps scored together (a power of two: one
    (row, column) pair a consumer thread, a row's steps x columns within
    a warp, at most half the stages); ``pw``, the entries of a row of
    the weight and rescale buffers."""
    rows = bk
    qstride = dh_pad + 4
    stage = rows * (qstride + COL_TILE)
    stage += (36 - stage % 32) % 32
    stages = min(max(_pow2_floor(max(KV_ROWS // rows, 1)), 2), KV_MAX_STAGES)
    return dict(rows=rows, qstride=qstride, stage=stage, stages=stages,
                **_groups(bm=bm, bk=bk, stages=stages))


def ring_bytes(c: int, *, bm: int, bk: int, dh_pad: int) -> int:
    """Dynamic shared memory of one K6 CTA: a full and an empty mbarrier
    for each of the :data:`WIN_SLOTS` window slots and
    :data:`KV_MAX_STAGES` stages, the slots' item records, the slots of
    ``c + 4`` entries for each of the weight and column streams, the K/V
    stages
    (:func:`kv_geometry`), the Q block at the K rows' stride, two halves
    of the weight and rescale buffers, and the denominators
    (``csrc/attn_fused_staged.cu::attn_ring_bytes`` computes the
    same)."""
    g = kv_geometry(bm=bm, bk=bk, dh_pad=dh_pad)
    barriers = 2 * (WIN_SLOTS + KV_MAX_STAGES) * 8 + WIN_SLOTS * ITEM_BYTES
    slots = 2 * WIN_SLOTS * (c + 4) * 4
    floats = (g["stages"] * g["stage"] + bm * g["qstride"]
              + 4 * bm * g["pw"] + -(-bm // 4) * 4)
    return barriers + slots + 4 * floats


HEAD_ALIGN = 32     # K5/K6 score whole rows of 32 lane partials


def head_width(dh: int) -> int:
    """The head width K5 runs at: ``dh`` rounded up to :data:`HEAD_ALIGN`."""
    return -(-int(dh) // HEAD_ALIGN) * HEAD_ALIGN


def _resident_bytes(g: dict, bm: int) -> int:
    barriers = 2 * (WIN_SLOTS + KV_MAX_STAGES) * 8 + WIN_SLOTS * ITEM_BYTES
    q_block = bm * g["qstride"] if g["stages"] else 0
    floats = (g["stages"] * g["stage"] + q_block + 4 * bm * g["pw"]
              + -(-bm // 4) * 4)
    return barriers + 4 * floats


def resident_geometry(*, bm: int, bk: int, dh_pad: int) -> dict:
    """K5's CTA at the kernel's head width ``dh_pad`` (a multiple of
    :data:`HEAD_ALIGN`; ``csrc/attn_ring.cuh::resident_geometry``
    computes the same): K6's ring (:func:`kv_geometry`) with each stage
    also holding the step's (bm x bk) weight panel, in whole 16-byte
    units, its stages halved (down to 1) until the CTA fits
    :data:`MAX_SHARED_BYTES`.  If not even one stage fits, ``stages`` is
    0 (LEAN): no ring and no Q block in shared memory, the Q rows and
    the K/V panels read in place at a stride of ``dh_pad``, the MXU
    groups bounded as by a :data:`KV_MAX_STAGES`-stage ring."""
    g = kv_geometry(bm=bm, bk=bk, dh_pad=dh_pad)
    stage = bk * (g["qstride"] + COL_TILE) + -(-bm * bk // 4) * 4
    g["stage"] = stage + (36 - stage % 32) % 32
    while g["stages"] > 1 and _resident_bytes(g, bm) > MAX_SHARED_BYTES:
        g["stages"] //= 2
        g.update(_groups(bm=bm, bk=bk, stages=g["stages"]))
    if _resident_bytes(g, bm) > MAX_SHARED_BYTES:
        g.update(qstride=dh_pad, stage=0, stages=0,
                 **_groups(bm=bm, bk=bk, stages=KV_MAX_STAGES))
    return g


def resident_ring_bytes(*, bm: int, bk: int, dh_pad: int) -> int:
    """Dynamic shared memory of one K5 CTA at head width ``dh_pad``: a
    full and an empty mbarrier for each of the :data:`WIN_SLOTS` trip
    slots and :data:`KV_MAX_STAGES` stages, the slots' item records, the
    stages of :func:`resident_geometry`, the Q block at the K rows'
    stride (none when LEAN), two halves of the weight and rescale
    buffers, and the denominators (``csrc/attn_ring.cuh::
    resident_bytes`` computes the same)."""
    return _resident_bytes(resident_geometry(bm=bm, bk=bk, dh_pad=dh_pad),
                           bm)


def head_padded(q_ws, k):
    """Q and K at :func:`head_width`: zero columns appended where the
    head width is not a multiple of :data:`HEAD_ALIGN`.  Each lane
    partial of a score (an fmaf chain over columns l, l + 32, ...) gains
    only fmaf(0, 0, x) terms, which leave its value as it was."""
    pad = head_width(q_ws.shape[1]) - q_ws.shape[1]
    if pad == 0:
        return q_ws, k
    return (torch.nn.functional.pad(q_ws, (0, pad)),
            torch.nn.functional.pad(k, (0, pad)))


class _Carry:
    """The online-softmax state of every descriptor's rows: ``acc``
    (B, bm, dv), running max ``m`` and denominator ``l`` (B, bm), and
    the workspace-ordered Q as (B, bm, dh)."""

    def __init__(self, q_ws, v, num_blocks: int, bm: int):
        self.q = q_ws.reshape(num_blocks, bm, q_ws.shape[1])
        self.acc = torch.zeros((num_blocks, bm, v.shape[1]),
                               dtype=torch.float32, device=v.device)
        self.m = torch.full((num_blocks, bm), NEG, dtype=torch.float32,
                            device=v.device)
        self.l = torch.zeros((num_blocks, bm), dtype=torch.float32,
                             device=v.device)

    def fold(self, b, z, w, vrows, *, block: bool):
        """Fold scores ``z`` and weights ``w`` (nb, bm, k) into
        descriptors ``b``'s carry, as ``_softmax_trip`` does: a VPU step
        (``k = 1``, ``vrows`` (nb, bm, dv), one V row per row) or an MXU
        block step (``k = bk``, ``vrows`` (nb, bk, dv), the block's
        product summed over the block in order)."""
        m = self.m[b]
        zm = torch.where(w > 0, z, torch.full_like(z, NEG))
        m_new = torch.maximum(m, zm.amax(-1))
        r = torch.exp(m - m_new)
        p = w * torch.exp(torch.clamp(z - m_new[..., None], max=0.0))
        if block:
            t = p[..., 0, None] * vrows[:, None, 0]
            for c in range(1, z.shape[2]):
                t = t + p[..., c, None] * vrows[:, None, c]
        else:
            t = p * vrows
        self.acc[b] = self.acc[b] * r[..., None] + t
        self.l[b] = self.l[b] * r + p.sum(-1)
        self.m[b] = m_new

    def vpu_steps(self, b, vrow, crow, n, cols, vals, k, v):
        """Steps ``[0, n[b])`` of VPU descriptors ``b``: row r's weight
        at ``vals[vrow[b, r] + s]``, its K/V row ``cols[crow[b, r] + s]``."""
        if b.numel() == 0:
            return
        for s in range(int(n.max())):
            live = n > s
            bb = b[live]
            w = vals[vrow[live] + s]                        # (nb, bm)
            kk = cols[crow[live] + s].long()
            z = (self.q[bb] * k[kk]).sum(-1)
            self.fold(bb, z[..., None], w[..., None], v[kk], block=False)

    def mxu_steps(self, b, voff, coff, n, cols, vals, k, v, *, bk: int):
        """Block steps ``[0, n[b])`` of MXU descriptors ``b``: step s's
        (bm x bk) weight panel at ``vals[voff[b] + s*bm*bk]``, its
        block-column ``cols[coff[b] + s]``."""
        if b.numel() == 0:
            return
        bm = self.q.shape[1]
        panel = torch.arange(bm * bk, device=v.device)
        rows = torch.arange(bk, device=v.device)
        for s in range(int(n.max())):
            live = n > s
            bb = b[live]
            w = vals[voff[live, None] + s * bm * bk + panel].view(-1, bm, bk)
            kr = cols[coff[live] + s].long()[:, None] * bk + rows   # (nb, bk)
            z = (self.q[bb][:, :, None, :] * k[kr][:, None]).sum(-1)
            self.fold(bb, z, w, v[kr], block=True)

    def out(self):
        l = self.l[..., None]
        y = self.acc / torch.where(l > 0, l, torch.ones_like(l))
        return y.reshape(-1, y.shape[-1])


def attn_fused_plain(blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat,
                     q_ws, k, v, *, bm: int = 8, bk: int = 8,
                     mw: int = 1) -> torch.Tensor:
    """Plain PyTorch K5: (B*bm, dv_pad) workspace rows.  Every merged
    member has its own carry, so ``mw`` does not change any row; the
    plain version accepts it and ignores it."""
    del mw
    tag, off, coff, L = _long(blk_tag, blk_off, blk_coff, blk_L)
    st = _Carry(q_ws, v, tag.shape[0], bm)
    ids = torch.arange(tag.shape[0], device=v.device)
    vpu, mxu = ids[tag == 0], ids[tag != 0]
    rr = torch.arange(bm, device=v.device) * L[vpu, None]
    st.vpu_steps(vpu, off[vpu, None] + rr, coff[vpu, None] + rr, L[vpu],
                 cols_flat, vals_flat, k, v)
    st.mxu_steps(mxu, off[mxu], coff[mxu], L[mxu], cols_flat, vals_flat, k,
                 v, bk=bk)
    return st.out()


def attn_fused_staged_plain(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                            vals_flat, q_ws, k, v, *, span: int, cspan: int,
                            bm: int = 8, bk: int = 8, mw: int = 1,
                            cap=None) -> torch.Tensor:
    """Plain PyTorch K6: (B*bm, dv_pad) workspace rows, through the same
    windows and chunks as the kernel.  The trips that fit a slot run
    together on buffers copied the way the kernel copies them (NaN or an
    out-of-range column beyond the copy); the members of the others run
    chunk by chunk in ``staged_walk``'s order, each member's carry living
    across its chunks — the j-th chunks of all of them at once."""
    tag, off, coff, L = _long(blk_tag, blk_off, blk_coff, blk_L)
    c, ch, kc = staging_geometry(span, cspan, bm=bm, bk=bk, cap=cap)
    st = _Carry(q_ws, v, tag.shape[0], bm)
    fit, chunks = [], []
    for item in staged_walk(tag.cpu(), off.cpu(), coff.cpu(), L.cpu(), bm=bm,
                            bk=bk, mw=mw, c=c, ch=ch, kc=kc):
        (fit if item[0] == "trip" else chunks).append(item)
    if fit:
        members, soff, scoff, cbuf, vbuf = fitting_buffers(
            fit, off, coff, cols_flat, vals_flat, mw=mw, slot=c + 4)
        mxu = tag[members] != 0
        vpu, blk = members[~mxu], members[mxu]
        rr = torch.arange(bm, device=v.device) * L[vpu, None]
        st.vpu_steps(vpu, soff[vpu, None] + rr, scoff[vpu, None] + rr,
                     L[vpu], cbuf, vbuf, k, v)
        st.mxu_steps(blk, soff[blk], scoff[blk], L[blk], cbuf, vbuf, k, v,
                     bk=bk)
    # chunk j of every chunked member at once (members are independent,
    # and each member's chunks run in order)
    groups = {}
    for kind, b, s0, s1 in chunks:
        if s1 > s0:
            step = kc if kind == "mxu" else ch
            groups.setdefault((s0 // step, kind), []).append((b, s0, s1))
    rr = torch.arange(bm, device=v.device)
    for (_, kind), items in sorted(groups.items()):
        b, s0, s1 = torch.tensor(items, device=v.device).T
        n = s1 - s0
        if kind == "vpu":
            _vpu_chunks(st, b, s0, n, off, coff, L, cols_flat, vals_flat, k,
                        v, rr=rr, ch=ch)
        else:
            _mxu_chunks(st, b, s0, n, off, coff, cols_flat, vals_flat, k, v,
                        bk=bk, slot=c + 4)
    return st.out()


def _vpu_chunks(st, b, s0, n, off, coff, L, cols_flat, vals_flat, k, v, *,
                rr, ch: int):
    """Steps ``[s0, s0 + n)`` of VPU descriptors ``b``, as K6 copies
    them: each row's segment in its own ``ch + 4``-entry buffer row,
    copied from its aligned-down start."""
    seg = rr * L[b, None] + s0[:, None]                     # (ni, bm)
    lens = n[:, None].expand_as(seg).reshape(-1)
    vbuf, va = _windows(vals_flat, (off[b, None] + seg).reshape(-1), lens,
                        ch + 4, float("nan"))
    cbuf, ca = _windows(cols_flat, (coff[b, None] + seg).reshape(-1), lens,
                        ch + 4, _INT_FILL)
    base = torch.arange(seg.numel(), device=v.device).view_as(seg) * (ch + 4)
    st.vpu_steps(b, base + off[b, None] + seg - va.view_as(seg),
                 base + coff[b, None] + seg - ca.view_as(seg), n, cbuf, vbuf,
                 k, v)


def _mxu_chunks(st, b, s0, n, off, coff, cols_flat, vals_flat, k, v, *,
                bk: int, slot: int):
    """Block steps ``[s0, s0 + n)`` of MXU descriptors ``b``, as K6
    copies them: the weight panels and block-columns from their
    aligned-down starts into one ``slot``-entry buffer each."""
    step = st.q.shape[1] * bk
    src_v, src_c = off[b] + s0 * step, coff[b] + s0
    vbuf, va = _windows(vals_flat, src_v, n * step, slot, float("nan"))
    cbuf, ca = _windows(cols_flat, src_c, n, slot, _INT_FILL)
    base = torch.arange(b.numel(), device=v.device) * slot
    st.mxu_steps(b, base + src_v - va, base + src_c - ca, n, cbuf, vbuf, k, v,
                 bk=bk)


def check_attn(tables, cols_flat, vals_flat, q_ws, k, v, *, bm: int,
               bk: int, mw: int) -> None:
    """Validate what K5/K6 read, before any pointer is taken: the
    descriptor tables and streams as for the SpMM kernels, f32 2-D
    contiguous Q/K/V on one device, Q with ``bm`` rows per descriptor,
    K and V with the same rows (a multiple of ``bk``), Q and K with the
    same head width, V with whole 128-column tiles and ``bk`` within a
    warp."""
    check_tables(tables, cols_flat, vals_flat, v, bm=bm, mw=mw)
    for name, t in (("q_ws", q_ws), ("k", k)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_blocks = next(iter(tables.values())).shape[0]
    if q_ws.shape[0] != num_blocks * bm:
        raise ValueError(f"q_ws has {q_ws.shape[0]} rows, the plan "
                         f"{num_blocks} x bm={bm}")
    if k.shape[1] != q_ws.shape[1] or k.shape[0] != v.shape[0]:
        raise ValueError(f"k {tuple(k.shape)} must share its width with "
                         f"q_ws {tuple(q_ws.shape)} and its rows with v "
                         f"{tuple(v.shape)}")
    _check_rows(k, bk)
    if bk > MAX_BK:
        raise ValueError(f"bk must be at most {MAX_BK}, got {bk}")
    if v.shape[1] % COL_TILE:
        raise ValueError(f"v must have a multiple of {COL_TILE} columns, "
                         f"got {v.shape[1]}")


def check_staged_attn(q_ws, *, c: int, bm: int, bk: int) -> None:
    """What a K6 launch needs beyond :func:`check_attn`: a head width
    that is a multiple of 32 (whole rows of the score's lane partials)
    and rings that fit a CTA's shared memory (:func:`ring_bytes`)."""
    if q_ws.shape[1] % 32:
        raise ValueError(f"the staged attention kernel takes a head width "
                         f"that is a multiple of 32, got {q_ws.shape[1]}")
    nbytes = ring_bytes(c, bm=bm, bk=bk, dh_pad=q_ws.shape[1])
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"a staging ring of {nbytes} bytes exceeds the "
                         f"{MAX_SHARED_BYTES} bytes a CTA may use")


def _tables(blk_tag, blk_off, blk_coff, blk_L):
    return {"blk_tag": blk_tag, "blk_off": blk_off, "blk_coff": blk_coff,
            "blk_L": blk_L}


def attn_fused(blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat, q_ws,
               k, v, *, bm: int = 8, bk: int = 8, mw: int = 1) -> torch.Tensor:
    """Compute the WHOLE sparse-attention plan in one launch:
    Y_ws (B*bm, dv_pad) = softmax(mask ⊙ (Q·Kᵀ)) · V.

    blk_tag   : (B,) int32 — 0 = VPU ELL block, 1 = MXU block-row
    blk_off   : (B,) int32 — first slot of each block in vals_flat
    blk_coff  : (B,) int32 — first entry of each block in cols_flat
    blk_L     : (B,) int32 — trips: padded nnz/row (VPU) or K (MXU)
    cols_flat : (Sc,) int32 — K/V row per slot (VPU) / block-column (MXU)
    vals_flat : (S,) float32 — mask weights >= 0, zero on padding
    q_ws      : (B*bm, dh_pad) float32 — Q in workspace row order, scale
                folded in
    k, v      : (n_pad, dh_pad), (n_pad, dv_pad) float32 — rows padded
                to a bk multiple, dv_pad a multiple of 128
    mw        : CGCM merge width — descriptors per CTA; divides B

    CPU tensors run :func:`attn_fused_plain`; CUDA tensors launch
    ``csrc/attn_fused.cu`` once (counted in ``attn_fused.launches``),
    with Q and K zero-padded to :func:`head_width` and Q, K and V on
    16-byte boundaries (``aligned16``).  It takes every head width: where
    K6's ring does not fit a CTA, :func:`resident_geometry` takes fewer
    stages or none.
    """
    check_attn(_tables(blk_tag, blk_off, blk_coff, blk_L), cols_flat,
               vals_flat, q_ws, k, v, bm=bm, bk=bk, mw=mw)
    if v.device.type == "cpu":
        return attn_fused_plain(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                                vals_flat, q_ws, k, v, bm=bm, bk=bk, mw=mw)
    num_blocks = blk_tag.shape[0]
    y = torch.empty((num_blocks * bm, v.shape[1]), dtype=torch.float32,
                    device=v.device)
    if num_blocks == 0 or v.shape[1] == 0:
        return y
    q_k, k_k = (aligned16(t) for t in head_padded(q_ws, k))
    v_k = aligned16(v)
    lib = _build.load("attn_fused", _ARGTYPES)
    # the persistent CTAs take their trips past the first from these
    # counters, one per column tile
    next_trip = torch.zeros(v.shape[1] // COL_TILE, dtype=torch.int32,
                            device=v.device)
    with torch.cuda.device(v.device):
        err = lib.attn_fused_launch(
            blk_tag.data_ptr(), blk_off.data_ptr(), blk_coff.data_ptr(),
            blk_L.data_ptr(), cols_flat.data_ptr(), vals_flat.data_ptr(),
            q_k.data_ptr(), k_k.data_ptr(), v_k.data_ptr(), y.data_ptr(),
            num_blocks // mw, bm, bk, mw, q_k.shape[1], v.shape[1],
            next_trip.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attn_fused launch failed with CUDA error {err}")
    attn_fused.launches += 1
    return y


attn_fused.launches = 0


def attn_fused_staged(blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat,
                      q_ws, k, v, *, span: int, cspan: int, bm: int = 8,
                      bk: int = 8, mw: int = 1, cap=None) -> torch.Tensor:
    """The staged fused attention launch (DESIGN.md §7.7/§13) —
    :func:`attn_fused`'s contract and bit-identical output.

    ``span``/``cspan`` are the workspace's ``max_span``/``max_cspan``:
    they size the ring's slots (capped at ``cap``, default
    ``STAGE_CAP`` entries), and a trip whose windows exceed the slot is
    walked in chunks.

    CPU tensors run :func:`attn_fused_staged_plain`; CUDA tensors launch
    ``csrc/attn_fused_staged.cu`` once (counted in
    ``attn_fused_staged.launches``).
    """
    check_attn(_tables(blk_tag, blk_off, blk_coff, blk_L), cols_flat,
               vals_flat, q_ws, k, v, bm=bm, bk=bk, mw=mw)
    c, ch, kc = staging_geometry(span, cspan, bm=bm, bk=bk, cap=cap)
    check_staged_attn(q_ws, c=c, bm=bm, bk=bk)
    if v.device.type == "cpu":
        return attn_fused_staged_plain(
            blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat, q_ws, k,
            v, span=span, cspan=cspan, bm=bm, bk=bk, mw=mw, cap=cap)
    for name, t in (("cols_flat", cols_flat), ("vals_flat", vals_flat),
                    ("q_ws", q_ws), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the staged kernel's copies")
    num_blocks = blk_tag.shape[0]
    y = torch.empty((num_blocks * bm, v.shape[1]), dtype=torch.float32,
                    device=v.device)
    if num_blocks == 0:
        return y
    lib = _build.load("attn_fused_staged", _STAGED_ARGTYPES)
    # the persistent CTAs take their trips past the first from these
    # counters, one per column tile
    next_trip = torch.zeros(v.shape[1] // COL_TILE, dtype=torch.int32,
                            device=v.device)
    with torch.cuda.device(v.device):
        err = lib.attn_fused_staged_launch(
            blk_tag.data_ptr(), blk_off.data_ptr(), blk_coff.data_ptr(),
            blk_L.data_ptr(), cols_flat.data_ptr(), vals_flat.data_ptr(),
            q_ws.data_ptr(), k.data_ptr(), v.data_ptr(), y.data_ptr(),
            num_blocks // mw, bm, bk, mw, q_ws.shape[1], v.shape[1], c, ch,
            kc, next_trip.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attn_fused_staged launch failed with CUDA "
                           f"error {err}")
    attn_fused_staged.launches += 1
    return y


attn_fused_staged.launches = 0


# -- K8: the sharded dispatch, one launch per chip ---------------------------

def _attn_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat,
                  q_ws, k, v, *, mesh, bm, bk, mw, staging, span, cspan, cap,
                  plain: bool):
    check_on_mesh(mesh, blk_tag=blk_tag, blk_off=blk_off, blk_coff=blk_coff,
                  blk_L=blk_L, cols_flat=cols_flat, vals_flat=vals_flat,
                  q_ws=q_ws, k=k, v=v)
    if staging == "dma":
        kernel = attn_fused_staged_plain if plain else attn_fused_staged
    else:
        kernel = attn_fused_plain if plain else attn_fused
    # Q per chip in its workspace order; K and V replicated
    per_chip = [(q, k.to(dev), v.to(dev)) for q, dev in
                zip(place_on_chips(q_ws, mesh), mesh.devices)]
    return run_on_chips(kernel, (blk_tag, blk_off, blk_coff, blk_L,
                                 cols_flat, vals_flat), per_chip, mesh=mesh,
                        staging=staging, span=span, cspan=cspan, cap=cap,
                        knobs=dict(bm=bm, bk=bk, mw=mw),
                        counter=None if plain else attn_fused_sharded)


def attn_fused_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                       vals_flat, q_ws, k, v, *, mesh, bm: int = 8,
                       bk: int = 8, mw: int = 1, staging: str = "resident",
                       span=0, cspan=0, cap=None) -> torch.Tensor:
    """K8 for attention: one K5 (``resident``) or K6 (``dma``) launch per
    chip of ``mesh``, each on its chip's device.

    The descriptor tables, weights and the workspace-ordered ``q_ws``
    (C, B*bm, dh_pad) are per chip (stacked or sequences; each chip's Q
    rows from its own ``workspace_row_map`` shard); K and V are
    replicated to every chip's device — attention rows read arbitrary
    key columns, so there is no row-sharded mode.  ``span``/``cspan``
    are an int or one window per chip.  Returns (C, B*bm, dv_pad) in
    chip order on the first chip's device; each chip's launch also
    counts in ``attn_fused_sharded.launches``."""
    return _attn_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                         vals_flat, q_ws, k, v, mesh=mesh, bm=bm, bk=bk,
                         mw=mw, staging=staging, span=span, cspan=cspan,
                         cap=cap, plain=False)


attn_fused_sharded.launches = 0


def attn_fused_sharded_plain(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                             vals_flat, q_ws, k, v, *, mesh, bm: int = 8,
                             bk: int = 8, mw: int = 1,
                             staging: str = "resident", span=0, cspan=0,
                             cap=None) -> torch.Tensor:
    """Plain PyTorch K8 for attention: the same chip loop through
    :func:`attn_fused_plain` / :func:`attn_fused_staged_plain`."""
    return _attn_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                         vals_flat, q_ws, k, v, mesh=mesh, bm=bm, bk=bk,
                         mw=mw, staging=staging, span=span, cspan=cspan,
                         cap=cap, plain=True)
