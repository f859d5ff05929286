"""Static verifier for the plan IR (DESIGN.md §15).

Port of ``src/repro/analysis/verify.py``, copied whole (numpy only),
except that the ``validate`` resolver lives in ``kernels/ops.py`` beside
the device resolver it keys on.  The text below is the reference's.

The repo's JIT thesis mirrors the paper's: the descriptor streams, flat
slot buffers, DMA windows, fetch tables and block-diagonal offsets the
plan pipeline emits are *generated programs* — and until now nothing
machine-checked them.  A wrong ``blk_off`` or a duplicated ``inv_perm``
entry surfaces only as silently wrong numerics (jax clamps OOB gathers)
deep inside a ``pallas_call``.  This module is the JIT assembler's
verifier: a pure-host, numpy-only pass over any workspace the pipeline
can produce —

  * :class:`~repro.core.plan.FusedEllWorkspace` (solo fused dispatch),
  * :class:`~repro.core.plan.ShardedFusedWorkspace` (chip axis,
    including the x-sharded fetch/send/recv tables),
  * :class:`~repro.core.plan.BatchedFusedWorkspace` (request axis,
    block-diagonal flatten), and
  * the attention instantiation of
    :class:`~repro.core.plan.SparseEinsumSpec` (mask-weight and
    softmax-state contracts)

— returning typed :class:`PlanViolation` findings instead of wrong
answers.  ``check_*`` raises :class:`PlanVerificationError` naming the
first findings BEFORE any device work.

Verification levels (the ``validate`` knob on ``compile_*``):

  off    no checks — zero host cost on the production dispatch path
  cheap  O(num_blocks + m) descriptor-table / window / permutation
         checks; never scans the O(S) flat streams
  full   cheap + the stream scans: gather/column bounds (after
         per-request or per-chip rebasing), fetch-table exactness,
         attention mask weights

The invariant catalog (kind strings are the mutation suite's contract,
tests/test_verify.py):

  ============================  ==========================================
  kind                          invariant
  ============================  ==========================================
  merge_alignment               num_blocks is a multiple of merge_width
  blk_off_monotone              real (L > 0) descriptors' slot/col
                                offsets never decrease within a member
  blk_bounds                    every descriptor's slot/col extent stays
                                inside its member's real stream region
  trip_span                     blk_span/blk_cspan equal the summed
                                extents of each merged trip's members
  pad_block_live                an inert pad block (L == 0) is targeted
                                by inv_perm (pads must be zero-trip AND
                                unread)
  perm_not_bijective            inv_perm has an OOB or duplicated entry
  perm_roundtrip                a STAGED forward row_map (the constant a
                                row-operand dispatch ships) does not
                                invert inv_perm / carry the pad sentinel
  perm_region                   a row maps outside its chip's/request's
                                workspace region
  dma_window                    a merged trip's real extent exceeds its
                                staged window, or the window overruns
                                the tail-padded stream / request region
  dma_window_alignment          window not STAGE_TILE-rounded (warning)
  gather_oob                    a gather index falls outside
                                [0, nnz] (or its request's vals range)
  cols_oob                      a column entry is out of bounds of its
                                (rebased) X buffer
  xshard_fetch                  fetch/send/recv tables inconsistent, or
                                fetch set != descriptor-derived touched
                                panel set (incl. forced panel 0)
  splits_malformed              row_splits/val_splits/bounds not
                                monotone from 0
  attn_mask_negative            an attention mask weight is negative
  attn_spec                     softmax-state flags inconsistent with
                                the einsum spec / workspace
  ============================  ==========================================

Adding an invariant alongside a new plan transform: pick a kind string,
emit :class:`PlanViolation` from the relevant ``verify_*`` function,
and seed one corruption for it in tests/test_verify.py — the mutation
suite is the proof the check can actually fire.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

VALIDATE_MODES = ("off", "cheap", "full")


@dataclasses.dataclass(frozen=True)
class PlanViolation:
    """One verifier finding: which invariant (``kind``), on which
    workspace field, at which offending indices.  ``severity`` is
    ``"error"`` (the plan would compute wrong answers or read out of
    bounds — :func:`check_workspace` raises) or ``"warning"``
    (suboptimal but safe — reported, never raised)."""
    kind: str
    field: str
    message: str
    severity: str = "error"
    indices: Tuple[int, ...] = ()

    def __str__(self) -> str:
        where = f" at {list(self.indices)}" if self.indices else ""
        return (f"[{self.severity}] {self.kind} ({self.field}){where}: "
                f"{self.message}")


class PlanVerificationError(ValueError):
    """Raised by the ``check_*`` entry points when a workspace carries
    error-severity violations — before any device constants are built,
    so a malformed plan can never reach a device."""

    def __init__(self, violations: Sequence[PlanViolation],
                 context: str = ""):
        self.violations = tuple(violations)
        head = "; ".join(str(v) for v in self.violations[:3])
        more = (f" (+{len(self.violations) - 3} more)"
                if len(self.violations) > 3 else "")
        prefix = f"{context}: " if context else ""
        super().__init__(
            f"{prefix}plan verification failed with "
            f"{len(self.violations)} violation(s): {head}{more}")


def check_workspace(ws, *, nnz: Optional[int] = None,
                    n_cols: Optional[int] = None,
                    spec: Optional[SparseEinsumSpec] = None,
                    vals: Optional[np.ndarray] = None,
                    row_map: Optional[np.ndarray] = None,
                    level: str = "full", context: str = "") -> None:
    """Raise :class:`PlanVerificationError` when ``ws`` carries any
    error-severity violation (warnings never raise).  ``level="off"``
    is a no-op — the zero-cost production setting."""
    if level == "off":
        return
    violations = [v for v in verify_workspace(
        ws, nnz=nnz, n_cols=n_cols, spec=spec, vals=vals,
        row_map=row_map, level=level)
        if v.severity == "error"]
    if violations:
        raise PlanVerificationError(violations, context=context)


# The plan import sits BELOW the names core.spmm pulls in at module top
# (PlanViolation, PlanVerificationError, check_workspace): importing
# this module first re-enters it via core/__init__ -> spmm, and that
# re-entry must find those names already bound.  Everything after this
# line only dereferences the plan symbols at call time.
from ..core.plan import (MXU_TAG, STAGE_TILE, BatchedFusedWorkspace,  # noqa: E402
                         FusedEllWorkspace, ShardedFusedWorkspace,
                         SparseEinsumSpec)


# -- shared helpers ----------------------------------------------------------

def _extents(tag: np.ndarray, L: np.ndarray, bm: int, bk: int):
    """Per-descriptor slot/column footprints: a VPU block's slots are
    its (bm, L) ELL panel (column stream slot-parallel), an MXU
    block-row's are its (L, bm, bk) value panels with only L column
    entries.  Pad blocks (L == 0) are zero either way."""
    L = L.astype(np.int64)
    span = np.where(tag == MXU_TAG, L * bm * bk, L * bm)
    cspan = np.where(tag == MXU_TAG, L, L * bm)
    return span, cspan


def _verify_member_tables(out: List[PlanViolation], *, tag, off, coff, L,
                          bm: int, bk: int, merge_width: int,
                          window: int, cwindow: int,
                          slot_lo: int, slot_hi: int, slot_buf_hi: int,
                          col_lo: int, col_hi: int, col_buf_hi: int,
                          member: str, idx_base: int = 0) -> None:
    """Descriptor-table + DMA-window checks for ONE member's descriptor
    row (a solo workspace, one chip's row, or one request's block range).

    ``[slot_lo, slot_hi)`` is the member's real slot region and
    ``slot_buf_hi`` the end of its addressable (tail-padded) buffer —
    identical for a solo workspace, distinct per request after the
    block-diagonal rebase.  ``idx_base`` offsets reported block indices
    back into the caller's flattened table."""
    B = int(L.shape[0])
    mw = max(int(merge_width), 1)
    if B % mw:
        out.append(PlanViolation(
            "merge_alignment", "blk_off",
            f"{member}: {B} descriptors not a multiple of "
            f"merge_width={mw}"))
        return
    span, cspan = _extents(tag, L, bm, bk)
    real = L > 0
    if np.any(L < 0):
        bad = np.flatnonzero(L < 0)
        out.append(PlanViolation(
            "blk_bounds", "blk_L",
            f"{member}: negative trip count",
            indices=tuple(int(i) + idx_base for i in bad[:4])))
        return
    # real descriptors: offsets monotone (the packer emits both streams
    # contiguously; stacked pads sit at off == 0 and are exempt)
    for name, kind_field, o in (("slot", "blk_off", off),
                                ("col", "blk_coff", coff)):
        o_real = o[real].astype(np.int64)
        if o_real.size > 1 and np.any(np.diff(o_real) < 0):
            where = np.flatnonzero(real)[
                np.flatnonzero(np.diff(o_real) < 0)]
            out.append(PlanViolation(
                "blk_off_monotone", kind_field,
                f"{member}: real {name} offsets decrease",
                indices=tuple(int(i) + idx_base for i in where[:4])))
    # every real descriptor's extent inside the member's real region
    o64, c64 = off.astype(np.int64), coff.astype(np.int64)
    bad = real & ((o64 < slot_lo) | (o64 + span > slot_hi))
    if np.any(bad):
        out.append(PlanViolation(
            "blk_bounds", "blk_off",
            f"{member}: descriptor slot extent outside real region "
            f"[{slot_lo}, {slot_hi})",
            indices=tuple(int(i) + idx_base
                          for i in np.flatnonzero(bad)[:4])))
    bad = real & ((c64 < col_lo) | (c64 + cspan > col_hi))
    if np.any(bad):
        out.append(PlanViolation(
            "blk_bounds", "blk_coff",
            f"{member}: descriptor col extent outside real region "
            f"[{col_lo}, {col_hi})",
            indices=tuple(int(i) + idx_base
                          for i in np.flatnonzero(bad)[:4])))
    # DMA-window coverage per merged trip (only when the workspace
    # advertises staged windows): the fixed-size copy
    # [off[g*W], off[g*W] + window) must contain every member block's
    # real extent and stay inside the tail-padded buffer
    if window <= 0:
        return
    trip_off = o64.reshape(-1, mw)
    trip_coff = c64.reshape(-1, mw)
    trip_span = span.reshape(-1, mw)
    trip_cspan = cspan.reshape(-1, mw)
    trip_real = real.reshape(-1, mw)
    for g in range(B // mw):
        for label, kind_field, o_g, s_g, win, buf_hi in (
                ("slot", "max_span", trip_off[g], trip_span[g], window,
                 slot_buf_hi),
                ("col", "max_cspan", trip_coff[g], trip_cspan[g],
                 cwindow, col_buf_hi)):
            start = int(o_g[0])
            if start + win > buf_hi:
                out.append(PlanViolation(
                    "dma_window", kind_field,
                    f"{member}: trip {g} {label} window "
                    f"[{start}, {start + win}) overruns the "
                    f"tail-padded buffer (end {buf_hi})",
                    indices=(idx_base + g * mw,)))
            ends = o_g + s_g
            over = trip_real[g] & ((o_g < start)
                                   | (ends > start + win))
            if np.any(over):
                out.append(PlanViolation(
                    "dma_window", kind_field,
                    f"{member}: trip {g} real {label} extent escapes "
                    f"its window [{start}, {start + win})",
                    indices=tuple(idx_base + g * mw + int(j)
                                  for j in np.flatnonzero(over)[:4])))


def _verify_trip_spans(out: List[PlanViolation], ws: FusedEllWorkspace
                       ) -> None:
    """Packed-workspace trip spans must equal the summed extents of
    each merged trip's members (trip counts consistent with blk_L)."""
    if ws.blk_span is None or ws.blk_cspan is None:
        return
    mw = max(ws.merge_width, 1)
    span, cspan = _extents(ws.blk_tag, ws.blk_L, ws.row_block, ws.bk)
    want = span.reshape(-1, mw).sum(axis=1)
    wantc = cspan.reshape(-1, mw).sum(axis=1)
    for name, have, need in (("blk_span", ws.blk_span, want),
                             ("blk_cspan", ws.blk_cspan, wantc)):
        have = np.asarray(have, np.int64)
        if have.shape != need.shape or np.any(have != need):
            bad = (np.flatnonzero(have != need)[:4]
                   if have.shape == need.shape else ())
            out.append(PlanViolation(
                "trip_span", name,
                f"{name} disagrees with the summed member extents",
                indices=tuple(int(i) for i in bad)))


def _verify_perm(out: List[PlanViolation], inv_perm: np.ndarray,
                 ws_rows: int, field: str = "inv_perm",
                 row_map: Optional[np.ndarray] = None) -> None:
    """``inv_perm`` must be injective into [0, ws_rows); a caller-
    STAGED forward ``row_map`` (the constant shipped to the kernel for
    row-indexed operands, e.g. attention's Q gather) must additionally
    compose with it back to the identity on output rows and carry the
    pad sentinel ``m`` everywhere else.  A freshly derived map inverts
    by construction — the round trip only means something for the
    artifact a dispatch will actually read."""
    m = int(inv_perm.shape[0])
    p = inv_perm.astype(np.int64)
    oob = (p < 0) | (p >= ws_rows)
    if np.any(oob):
        out.append(PlanViolation(
            "perm_not_bijective", field,
            f"{int(oob.sum())} entries outside [0, {ws_rows})",
            indices=tuple(int(i) for i in np.flatnonzero(oob)[:4])))
        return
    counts = np.bincount(p, minlength=ws_rows)
    if np.any(counts > 1):
        dup_rows = np.flatnonzero(counts > 1)[:2]
        idx = [int(i) for r in dup_rows for i in np.flatnonzero(p == r)]
        out.append(PlanViolation(
            "perm_not_bijective", field,
            f"{int((counts > 1).sum())} workspace rows targeted twice",
            indices=tuple(idx[:4])))
        return
    if row_map is None:
        return
    rm = np.asarray(row_map, np.int64).reshape(-1)
    if rm.shape[0] != ws_rows:
        out.append(PlanViolation(
            "perm_roundtrip", "row_map",
            f"staged row_map has {rm.shape[0]} slots, workspace has "
            f"{ws_rows}"))
        return
    want = np.full(ws_rows, m, dtype=np.int64)
    want[p] = np.arange(m, dtype=np.int64)
    bad = rm != want
    if np.any(bad):
        out.append(PlanViolation(
            "perm_roundtrip", "row_map",
            "staged row_map does not invert inv_perm (round trip is "
            "not the identity / pad slots not the sentinel m)",
            indices=tuple(int(i) for i in np.flatnonzero(bad)[:4])))


def _verify_pads_unread(out: List[PlanViolation], inv_perm: np.ndarray,
                        blk_L: np.ndarray, row_block: int,
                        field: str = "inv_perm") -> None:
    """Inert pad blocks are truly zero-trip AND unread: no output row
    may gather from a block whose trip count is 0 (its workspace rows
    were never written)."""
    blk_of_row = inv_perm.astype(np.int64) // row_block
    valid = (blk_of_row >= 0) & (blk_of_row < blk_L.shape[0])
    live_pad = valid & (blk_L.reshape(-1)[
        np.clip(blk_of_row, 0, blk_L.shape[0] - 1)] == 0)
    if np.any(live_pad):
        out.append(PlanViolation(
            "pad_block_live", field,
            f"{int(live_pad.sum())} output rows gather from zero-trip "
            f"pad blocks",
            indices=tuple(int(i)
                          for i in np.flatnonzero(live_pad)[:4])))


def _verify_gather(out: List[PlanViolation], gather: np.ndarray,
                   nnz: int, *, lo: int = 0, hi: Optional[int] = None,
                   member: str = "workspace") -> None:
    """Every gather index must address ``concat(vals, [0])``: real
    entries in ``[lo, hi)`` (the member's vals range), pads exactly the
    global sentinel ``nnz``."""
    g = gather.astype(np.int64).reshape(-1)
    hi = nnz if hi is None else hi
    bad = (g != nnz) & ((g < lo) | (g >= hi))
    if np.any(bad):
        where = np.flatnonzero(bad)
        out.append(PlanViolation(
            "gather_oob", "gather_flat",
            f"{member}: {where.size} gather indices outside "
            f"[{lo}, {hi}) ∪ {{{nnz}}}",
            indices=tuple(int(i) for i in where[:4])))


def _real_col_mask(tag, coff, L, *, base: int, size: int, bm: int):
    """Boolean masks over one member's real column region: which
    entries are descriptor-referenced at all, and which of those are
    MXU block-column ids (vs VPU row ids)."""
    referenced = np.zeros(size, bool)
    mxu = np.zeros(size, bool)
    _, cspan = _extents(tag, L, bm, 1)
    for t, c, s in zip(tag, coff.astype(np.int64) - base, cspan):
        if s <= 0:
            continue
        c0, c1 = max(int(c), 0), min(int(c + s), size)
        if c1 <= c0:
            continue
        referenced[c0:c1] = True
        if t == MXU_TAG:
            mxu[c0:c1] = True
    return referenced, mxu


def _verify_cols(out: List[PlanViolation], cols: np.ndarray, *,
                 tag, coff, L, base: int, bm: int,
                 vpu_lo: int, vpu_hi: int, mxu_lo: int, mxu_hi: int,
                 member: str = "workspace") -> None:
    """Descriptor-referenced column entries must address their X
    buffer: VPU slots name rows in [vpu_lo, vpu_hi), MXU entries
    block-columns in [mxu_lo, mxu_hi) — both AFTER any per-chip panel
    remap or per-request block-diagonal rebase."""
    c = cols.astype(np.int64)
    referenced, mxu = _real_col_mask(tag, coff, L, base=base,
                                     size=c.shape[0], bm=bm)
    bad = referenced & np.where(mxu, (c < mxu_lo) | (c >= mxu_hi),
                                (c < vpu_lo) | (c >= vpu_hi))
    if np.any(bad):
        where = np.flatnonzero(bad)
        out.append(PlanViolation(
            "cols_oob", "cols_flat",
            f"{member}: {where.size} column entries out of bounds "
            f"(VPU rows [{vpu_lo}, {vpu_hi}), MXU block-cols "
            f"[{mxu_lo}, {mxu_hi}))",
            indices=tuple(int(i) for i in where[:4])))


def _warn_window_alignment(out: List[PlanViolation], window: int,
                           cwindow: int, member: str = "workspace"
                           ) -> None:
    for name, w in (("max_span", window), ("max_cspan", cwindow)):
        if w > 0 and w % STAGE_TILE:
            out.append(PlanViolation(
                "dma_window_alignment", name,
                f"{member}: {name}={w} not a multiple of "
                f"STAGE_TILE={STAGE_TILE} (wastes staged-copy width)",
                severity="warning"))


# -- per-type verifiers ------------------------------------------------------

def verify_fused_workspace(ws: FusedEllWorkspace, *,
                           nnz: Optional[int] = None,
                           n_cols: Optional[int] = None,
                           row_map: Optional[np.ndarray] = None,
                           level: str = "full") -> List[PlanViolation]:
    """Verify a solo packed workspace.  ``nnz`` overrides the stamped
    ``ws.nnz`` (hand-built workspaces may carry -1 = unknown, which
    skips the gather-bounds check); ``n_cols`` is the instance's column
    count n (bounds the VPU row / MXU block-column streams) — omitted,
    the column-bounds check is skipped.  ``row_map`` is the STAGED
    forward map a row-operand dispatch will ship (attention's Q
    gather) — supplied, it must round-trip with ``inv_perm``."""
    out: List[PlanViolation] = []
    if level == "off":
        return out
    bm, bk = ws.row_block, ws.bk
    S_buf = int(ws.gather_flat.shape[0])
    Sc_buf = int(ws.cols_flat.shape[0])
    s_real = S_buf - ws.max_span if ws.max_span > 0 else S_buf
    c_real = Sc_buf - ws.max_cspan if ws.max_cspan > 0 else Sc_buf
    if ws.ws_rows != ws.num_blocks * bm:
        out.append(PlanViolation(
            "blk_bounds", "ws_rows",
            f"ws_rows={ws.ws_rows} != num_blocks*row_block="
            f"{ws.num_blocks * bm}"))
    _verify_member_tables(
        out, tag=ws.blk_tag, off=ws.blk_off, coff=ws.blk_coff,
        L=ws.blk_L, bm=bm, bk=bk, merge_width=ws.merge_width,
        window=ws.max_span, cwindow=ws.max_cspan,
        slot_lo=0, slot_hi=s_real, slot_buf_hi=S_buf,
        col_lo=0, col_hi=c_real, col_buf_hi=Sc_buf,
        member="workspace")
    _verify_trip_spans(out, ws)
    _verify_perm(out, ws.inv_perm, ws.ws_rows, row_map=row_map)
    _verify_pads_unread(out, ws.inv_perm, ws.blk_L, bm)
    _warn_window_alignment(out, ws.max_span, ws.max_cspan)
    if level != "full":
        return out
    eff_nnz = ws.nnz if nnz is None else int(nnz)
    if eff_nnz >= 0:
        _verify_gather(out, ws.gather_flat, eff_nnz)
    if n_cols is not None:
        _verify_cols(out, ws.cols_flat, tag=ws.blk_tag,
                     coff=ws.blk_coff, L=ws.blk_L, base=0, bm=bm,
                     vpu_lo=0, vpu_hi=max(int(n_cols), 1),
                     mxu_lo=0, mxu_hi=max(-(-int(n_cols) // bk), 1))
    return out


def _verify_xshard_tables(out: List[PlanViolation],
                          sw: ShardedFusedWorkspace,
                          touched: List[np.ndarray]) -> None:
    """Fetch/send/recv mutual consistency + exactness against the
    descriptor-derived touched-panel sets (``touched[c]`` = local panel
    ids chip c's real column stream references, incl. the forced 0)."""
    C = sw.n_chips
    T = int(sw.x_fetch.shape[1])
    T2 = int(sw.x_send.shape[2])
    own = max(sw.x_own_panels, 1)
    for c in range(C):
        need = touched[c]
        k = int(need.size)
        fetch = sw.x_fetch[c].astype(np.int64)
        # exactness: the real prefix must BE the touched set in local
        # order (lut maps the sorted global need onto 0..k-1)
        if k > T:
            out.append(PlanViolation(
                "xshard_fetch", "x_fetch",
                f"chip {c}: touched-panel set ({k}) exceeds table "
                f"width ({T})", indices=(c,)))
            continue
        prefix = fetch[:k]
        if (k == 0 or prefix[0] != 0
                or np.any(np.diff(prefix) <= 0) and k > 1):
            out.append(PlanViolation(
                "xshard_fetch", "x_fetch",
                f"chip {c}: real fetch prefix is not sorted-unique "
                f"starting at panel 0", indices=(c,)))
            continue
        if np.any(prefix >= sw.x_panels) or np.any(prefix < 0):
            out.append(PlanViolation(
                "xshard_fetch", "x_fetch",
                f"chip {c}: fetch entry names a panel outside "
                f"[0, {sw.x_panels})", indices=(c,)))
            continue
        if np.any(fetch[k:] != 0):
            out.append(PlanViolation(
                "xshard_fetch", "x_fetch",
                f"chip {c}: fetch padding past the {k} real entries "
                f"is not panel 0", indices=(c,)))
        # coverage: local panels referenced by the descriptors must be
        # exactly {0..k-1} — a stale table either fetches a panel
        # nobody touches or misses one somebody does
        want = np.zeros(k, bool)
        want[0] = True
        in_range = touched[c][touched[c] < k] if k else touched[c]
        # touched holds LOCAL ids: mark and compare
        want = np.zeros(max(k, 1), bool)
        want[0] = True
        local = need
        if np.any(local >= k) or np.any(local < 0):
            out.append(PlanViolation(
                "xshard_fetch", "x_fetch",
                f"chip {c}: column stream references local panel "
                f">= real fetch count {k}", indices=(c,)))
            continue
        want[local] = True
        if not want.all():
            missing = np.flatnonzero(~want)
            out.append(PlanViolation(
                "xshard_fetch", "x_fetch",
                f"chip {c}: fetch table carries {missing.size} "
                f"panel(s) the descriptor stream never touches",
                indices=(c, int(missing[0]))))
        # mutual consistency with send/recv: panel p is owned by chip
        # p // own_panels; rank = p's position among this chip's needs
        # from that owner; recv index = owner * T2 + rank
        counts: dict = {}
        for t in range(k):
            p = int(prefix[t])
            src = p // own
            rank = counts.get(src, 0)
            counts[src] = rank + 1
            if src >= C or rank >= T2:
                out.append(PlanViolation(
                    "xshard_fetch", "x_send",
                    f"chip {c}: panel {p} owner/rank ({src}, {rank}) "
                    f"outside the send table", indices=(c, t)))
                continue
            if int(sw.x_send[src, c, rank]) != p - src * own:
                out.append(PlanViolation(
                    "xshard_fetch", "x_send",
                    f"chip {c}: send[{src}][{c}][{rank}] != local "
                    f"panel of {p}", indices=(c, t)))
            if int(sw.x_recv[c, t]) != src * T2 + rank:
                out.append(PlanViolation(
                    "xshard_fetch", "x_recv",
                    f"chip {c}: recv[{t}] != owner*T2+rank "
                    f"({src * T2 + rank})", indices=(c, t)))


def verify_sharded_workspace(sw: ShardedFusedWorkspace, *,
                             n_cols: Optional[int] = None,
                             row_map: Optional[np.ndarray] = None,
                             level: str = "full"
                             ) -> List[PlanViolation]:
    """Verify a chip-stacked workspace: every chip row runs the member
    checks against ITS OWN staged window, the global permutation must
    land each output row inside its owning chip's region (``bounds``),
    and under ``x_sharding="rows"`` the fetch/send/recv tables must be
    mutually consistent and exactly cover the touched-panel sets."""
    out: List[PlanViolation] = []
    if level == "off":
        return out
    bm, bk, C = sw.row_block, sw.bk, sw.n_chips
    S_buf = int(sw.gather_flat.shape[1])
    Sc_buf = int(sw.cols_flat.shape[1])
    b = np.asarray(sw.bounds, np.int64)
    if b.shape != (C + 1,) or b[0] != 0 or np.any(np.diff(b) < 0):
        out.append(PlanViolation(
            "splits_malformed", "bounds",
            f"bounds must rise monotonically from 0 over {C} chips"))
        return out
    nnz = sw.nnz
    for c in range(C):
        win = int(sw.chip_span[c])
        cwin = int(sw.chip_cspan[c])
        _verify_member_tables(
            out, tag=sw.blk_tag[c], off=sw.blk_off[c],
            coff=sw.blk_coff[c], L=sw.blk_L[c], bm=bm, bk=bk,
            merge_width=sw.merge_width, window=win, cwindow=cwin,
            slot_lo=0, slot_hi=max(S_buf - win, 0) if win else S_buf,
            slot_buf_hi=S_buf,
            col_lo=0, col_hi=max(Sc_buf - cwin, 0) if cwin else Sc_buf,
            col_buf_hi=Sc_buf, member=f"chip {c}")
        _verify_pads_unread(
            out, sw.inv_perm[b[c]:b[c + 1]] - c * sw.ws_rows,
            sw.blk_L[c], bm)
    _verify_perm(out, sw.inv_perm, C * sw.ws_rows, row_map=row_map)
    chip_of_row = sw.inv_perm.astype(np.int64) // max(sw.ws_rows, 1)
    owner = np.repeat(np.arange(C), np.diff(b))
    if chip_of_row.shape == owner.shape and np.any(chip_of_row != owner):
        bad = np.flatnonzero(chip_of_row != owner)
        out.append(PlanViolation(
            "perm_region", "inv_perm",
            f"{bad.size} output rows map outside their owning chip's "
            f"workspace region",
            indices=tuple(int(i) for i in bad[:4])))
    _warn_window_alignment(out, sw.max_span, sw.max_cspan)
    if level != "full":
        return out
    _verify_gather(out, sw.gather_flat, nnz)
    touched: List[np.ndarray] = []
    for c in range(C):
        cwin = int(sw.chip_cspan[c])
        c_real = max(Sc_buf - cwin, 0) if cwin else Sc_buf
        cols = sw.cols_flat[c].astype(np.int64)
        referenced, mxu = _real_col_mask(
            sw.blk_tag[c], sw.blk_coff[c], sw.blk_L[c], base=0,
            size=Sc_buf, bm=bm)
        if sw.x_sharding == "rows":
            T = sw.x_local_panels
            _verify_cols(out, cols, tag=sw.blk_tag[c],
                         coff=sw.blk_coff[c], L=sw.blk_L[c], base=0,
                         bm=bm, vpu_lo=0, vpu_hi=max(T * bk, 1),
                         mxu_lo=0, mxu_hi=max(T, 1),
                         member=f"chip {c}")
            pan = np.where(mxu, cols, cols // bk)[referenced & (
                np.arange(Sc_buf) < c_real)]
            touched.append(np.unique(
                np.concatenate([np.zeros(1, np.int64), pan])))
        elif n_cols is not None:
            _verify_cols(out, cols, tag=sw.blk_tag[c],
                         coff=sw.blk_coff[c], L=sw.blk_L[c], base=0,
                         bm=bm, vpu_lo=0, vpu_hi=max(int(n_cols), 1),
                         mxu_lo=0,
                         mxu_hi=max(-(-int(n_cols) // bk), 1),
                         member=f"chip {c}")
    if sw.x_sharding == "rows" and sw.x_fetch is not None:
        _verify_xshard_tables(out, sw, touched)
    return out


def verify_batched_workspace(bw: BatchedFusedWorkspace, *,
                             level: str = "full"
                             ) -> List[PlanViolation]:
    """Verify a request-stacked, block-diagonally flattened workspace:
    each request's descriptor range is checked against ITS region of
    the flat streams (offsets after the ``r*S``/``r*Sc`` rebase), the
    uniform staged window must never cross a request boundary, gather
    entries must stay inside their request's vals range, and column
    entries inside their request's X strip."""
    out: List[PlanViolation] = []
    if level == "off":
        return out
    R = bw.n_requests
    bm, bk = bw.row_block, bw.bk
    if R < 1 or bw.num_blocks % R:
        out.append(PlanViolation(
            "splits_malformed", "num_blocks",
            f"num_blocks={bw.num_blocks} not divisible by "
            f"n_requests={R}"))
        return out
    for name, splits, total in (
            ("row_splits", bw.row_splits, int(bw.inv_perm.shape[0])),
            ("val_splits", bw.val_splits, None)):
        s = np.asarray(splits, np.int64)
        if (s.shape != (R + 1,) or s[0] != 0
                or np.any(np.diff(s) < 0)
                or (total is not None and s[-1] != total)):
            out.append(PlanViolation(
                "splits_malformed", name,
                f"{name} must rise monotonically from 0"
                + (f" to {total}" if total is not None else "")))
            return out
    B = bw.num_blocks // R
    S = int(bw.gather_flat.shape[0]) // R
    Sc = int(bw.cols_flat.shape[0]) // R
    ws_rows_r = bw.ws_rows // R
    x_blocks = bw.x_rows_pad // bk
    total_nnz = bw.nnz
    rs = np.asarray(bw.row_splits, np.int64)
    vs = np.asarray(bw.val_splits, np.int64)
    for r in range(R):
        sl = slice(r * B, (r + 1) * B)
        win, cwin = bw.max_span, bw.max_cspan
        _verify_member_tables(
            out, tag=bw.blk_tag[sl], off=bw.blk_off[sl],
            coff=bw.blk_coff[sl], L=bw.blk_L[sl], bm=bm, bk=bk,
            merge_width=bw.merge_width, window=win, cwindow=cwin,
            slot_lo=r * S,
            slot_hi=(r + 1) * S - win if win else (r + 1) * S,
            slot_buf_hi=(r + 1) * S,
            col_lo=r * Sc,
            col_hi=(r + 1) * Sc - cwin if cwin else (r + 1) * Sc,
            col_buf_hi=(r + 1) * Sc,
            member=f"request {r}", idx_base=r * B)
        _verify_pads_unread(
            out, bw.inv_perm[rs[r]:rs[r + 1]] - r * ws_rows_r,
            bw.blk_L[sl], bm)
    _verify_perm(out, bw.inv_perm, bw.ws_rows)
    req_of_row = bw.inv_perm.astype(np.int64) // max(ws_rows_r, 1)
    owner = np.repeat(np.arange(R), np.diff(rs))
    if req_of_row.shape == owner.shape and np.any(req_of_row != owner):
        bad = np.flatnonzero(req_of_row != owner)
        out.append(PlanViolation(
            "perm_region", "inv_perm",
            f"{bad.size} output rows map outside their request's "
            f"workspace region",
            indices=tuple(int(i) for i in bad[:4])))
    _warn_window_alignment(out, bw.max_span, bw.max_cspan)
    if level != "full":
        return out
    for r in range(R):
        _verify_gather(out, bw.gather_flat[r * S:(r + 1) * S],
                       total_nnz, lo=int(vs[r]), hi=int(vs[r + 1]),
                       member=f"request {r}")
        sl = slice(r * B, (r + 1) * B)
        _verify_cols(
            out, bw.cols_flat[r * Sc:(r + 1) * Sc],
            tag=bw.blk_tag[sl], coff=bw.blk_coff[sl], L=bw.blk_L[sl],
            base=r * Sc, bm=bm,
            vpu_lo=r * bw.x_rows_pad, vpu_hi=(r + 1) * bw.x_rows_pad,
            mxu_lo=r * x_blocks, mxu_hi=(r + 1) * x_blocks,
            member=f"request {r}")
    return out


def verify_attention_contract(spec: SparseEinsumSpec,
                              vals: Optional[np.ndarray] = None, *,
                              has_mxu: bool = False,
                              level: str = "full"
                              ) -> List[PlanViolation]:
    """The attention instantiation's extra contracts (DESIGN.md §13):
    the segment-softmax spec needs a Q row operand and K AND V column
    operands, its mixed flag must match the workspace's tagging, and
    the mask weights ``w`` must be non-negative — ``w <= 0`` entries
    are treated as absent by the running max, and the cross-trip clamp
    rescale is only exact under that contract."""
    out: List[PlanViolation] = []
    if level == "off":
        return out
    if spec.segment_softmax:
        if spec.row_operands < 1 or spec.col_operands < 2:
            out.append(PlanViolation(
                "attn_spec", "spec",
                f"segment_softmax needs a row operand (Q) and two "
                f"column operands (K, V); spec has "
                f"{spec.row_operands}/{spec.col_operands}"))
        if not spec.mixed and has_mxu:
            out.append(PlanViolation(
                "attn_spec", "blk_tag",
                "non-mixed softmax spec but the workspace tags MXU "
                "block-rows"))
    if level == "full" and vals is not None and spec.segment_softmax:
        w = np.asarray(vals)
        bad = ~(w >= 0)          # catches negatives AND NaNs
        if np.any(bad):
            where = np.flatnonzero(bad)
            out.append(PlanViolation(
                "attn_mask_negative", "vals",
                f"{where.size} mask weights violate the w >= 0 "
                f"softmax contract",
                indices=tuple(int(i) for i in where[:4])))
    return out


# -- dispatch + raising entry points -----------------------------------------

def verify_workspace(ws, *, nnz: Optional[int] = None,
                     n_cols: Optional[int] = None,
                     spec: Optional[SparseEinsumSpec] = None,
                     vals: Optional[np.ndarray] = None,
                     row_map: Optional[np.ndarray] = None,
                     level: str = "full") -> List[PlanViolation]:
    """Type-dispatching front door: verify any workspace the plan
    pipeline can produce, returning ALL findings (errors and
    warnings).  ``spec``/``vals`` add the attention contracts on top
    of the structural checks; ``row_map`` is a staged forward map to
    round-trip against ``inv_perm`` (row-operand dispatches)."""
    if level not in VALIDATE_MODES:
        raise ValueError(
            f"level must be one of {VALIDATE_MODES}, got {level!r}")
    if isinstance(ws, ShardedFusedWorkspace):
        out = verify_sharded_workspace(ws, n_cols=n_cols,
                                       row_map=row_map, level=level)
    elif isinstance(ws, BatchedFusedWorkspace):
        out = verify_batched_workspace(ws, level=level)
    elif isinstance(ws, FusedEllWorkspace):
        out = verify_fused_workspace(ws, nnz=nnz, n_cols=n_cols,
                                     row_map=row_map, level=level)
    else:
        raise TypeError(
            f"verify_workspace: unsupported workspace type "
            f"{type(ws).__name__}")
    if spec is not None:
        out += verify_attention_contract(
            spec, vals, has_mxu=bool(getattr(ws, "has_mxu", False)),
            level=level)
    return out
