"""Workload division + instance specialization — paper §IV-B, at plan time.

Port of ``src/repro/core/plan.py``, copied whole: the planner is numpy
only, and the port's workspaces must be ``np.array_equal`` to the
reference's, so the constants (``STAGE_TILE``, ``MAX_MERGE_WIDTH``,
``VPU_TAG``/``MXU_TAG``) and every stage stay identical.  The text
below is the reference's; "grid program" reads "CTA" on the GPU, where
the fused kernels in ``kernels/`` consume the same descriptor stream.

The paper divides SpMM work across CPU threads three ways (Fig. 6):
row-split, nnz-split, merge-split, and JIT-generates a different binary
for each.  On TPU the "threads" are Pallas grid programs, which are
statically scheduled, so *all* balancing moves to plan time (DESIGN.md
§7.2) where — unlike an AOT binary — we can see the full ``row_ptr``.

A plan groups rows into **ELL segments**: each segment is a set of rows
padded to a common nonzeros-per-row ``L`` and lowered as one
``pallas_call`` with a fully static grid (the TPU analogue of "generated
code with no data-dependent branches").  The three strategies differ in
how rows are grouped, i.e. how much padding (wasted FLOPs) and how much
locality they trade:

  row_split    one segment, original row order, L = max row length.
               Fastest to plan; faithful to Fig. 6(a) including its
               weakness (skewed rows ⇒ huge padding).
  nnz_split    rows bucketed by length (geometric buckets) ⇒ per-bucket
               L is tight ⇒ near-equal real work per program.  The
               plan-time realization of Fig. 6(b)'s equal-nnz goal.
  merge_split  merge-path walk over (rows, nnz) cutting segments at
               equal rows+nnz quotas, preserving row order (locality)
               while bounding padding — Fig. 6(c).

The padded-gather trick keeps *values* dynamic: ``gather_idx`` maps each
ELL slot to an index in ``concat(vals, [0])`` so the same compiled plan
serves any values with this structure (jit-function semantics).

Plan construction is a **transform pipeline** (DESIGN.md §7.9):

  build   group rows into ELL segments (:func:`build_plan`)
  merge   pick the CGCM merge width ``W`` from the global row-length
          distribution (:func:`choose_merge_width`) — the paper's
          coarse-grain merging applied to descriptor trips: runs of
          short/empty block-rows share ONE merged grid step
  tag     per-block-row execution-unit selection for the mixed backend
          (:func:`tag_block_rows`, folded into :func:`build_mixed_plan`)
  pack    flatten everything into the descriptor stream
          (:func:`_pack_workspace`, merge-width aware)
  shard   partition rows across chips at merged-trip boundaries and run
          the same pipeline per chip (:func:`build_sharded_workspace`)

:func:`build_workspace` composes build/merge/tag/pack for the
single-chip path; each stage stays independently callable so the
autotuner (``core.autotune``) can re-run cheap stages per candidate
without repacking everything.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from .ccm import DTiling, plan_d_tiles

STRATEGIES = ("row_split", "nnz_split", "merge_split")

# Block-row descriptor tags in the fused workspace: which execution unit
# a row-block's descriptor drives inside the single mixed dispatch.
VPU_TAG = 0   # scalar-row ELL gather+FMA (the faithful CCM path)
MXU_TAG = 1   # (bm x bk) block matmuls (the beyond-paper BCSR path)

# DMA staging tile (DESIGN.md §7.7): the staged kernels prefetch each
# block's slot/cols panel as ONE fixed-size async copy, so every
# workspace's per-block maxima are rounded up to this granularity (the
# TPU lane count — a 1-D DMA window that tiles VREG lanes exactly) and
# the flat buffers are tail-padded so any window starting at a real
# block offset stays in bounds.
STAGE_TILE = 128


def _stage_tile_ceil(v: int) -> int:
    return -(-int(v) // STAGE_TILE) * STAGE_TILE


# CGCM merge widths are powers of two so merged trips nest evenly in the
# descriptor stream and the kernels' static unroll stays small
MAX_MERGE_WIDTH = 8


def choose_merge_width(row_ptr, *, row_block: int = 8,
                       merge_threshold: int = 0,
                       wmax: int = MAX_MERGE_WIDTH) -> int:
    """The CGCM **merge** stage (DESIGN.md §7.9): pick how many
    consecutive block-row descriptors share one merged grid step.

    The paper's coarse-grain merging coalesces short rows so no hardware
    lane idles on a near-empty row; here the wasted resource is a whole
    *grid step* — a block-row with one nonzero still costs a descriptor
    trip, its output store, and (staged) a DMA window round-trip.  On a
    powerlaw instance most block-rows are short, so the fixed per-step
    cost dominates.

    ``merge_threshold`` is the target trip count per merged step: the
    width ``W`` (a power of two, capped at ``wmax``) doubles while the
    *typical* trips a merged step would execute stays within the
    threshold.  "Typical" is the median per-block trip count over the
    length-sorted row order (the nnz_split view, where short rows group
    together) — a mean would be dominated by exactly the hot rows a
    skewed instance has, masking the short-block majority merging
    exists for.  ``0`` (the default) disables merging — every existing
    plan layout is byte-identical to the pre-CGCM packer.  Long-row
    instances keep ``W == 1`` automatically: their median per-block
    trip count already exceeds any sane threshold, and merging would
    only inflate the staged DMA windows.

    Deterministic, structure-only, and computed from the GLOBAL
    ``row_ptr`` — the sharded path calls this once before
    :func:`partition_rows_for_chips` so every chip packs with the same
    width and chip bounds cut at merged-trip boundaries.
    """
    if merge_threshold <= 0:
        return 1
    lengths = np.diff(np.asarray(row_ptr))
    m = int(lengths.shape[0])
    if m == 0:
        return 1
    # per-block-row trip count = max row length in the block, over the
    # length-sorted order (the padded ELL trip count a short-row bucket
    # pays whatever the grouping strategy chooses later)
    nblk = -(-m // row_block)
    padded = np.zeros(nblk * row_block, dtype=np.int64)
    padded[:m] = np.sort(lengths)
    trips = np.maximum(padded.reshape(nblk, row_block).max(axis=1), 1)
    typical = float(np.median(trips))
    w = 1
    while w < wmax and typical * (w * 2) <= merge_threshold:
        w *= 2
    return w


@dataclasses.dataclass
class EllSegment:
    row_ids: np.ndarray      # (R,) original row indices (host)
    L: int                   # padded nnz per row in this segment
    R_pad: int               # rows padded up (multiple of row_block)
    cols_pad: np.ndarray     # (R_pad, max(L,1)) int32, pad -> col 0
    gather_idx: np.ndarray   # (R_pad, max(L,1)) int64 into concat(vals,[0])

    @property
    def R(self) -> int:
        return int(self.row_ids.shape[0])

    @property
    def padded_nnz(self) -> int:
        return self.R_pad * max(self.L, 1)


@dataclasses.dataclass
class SpmmPlan:
    strategy: str
    m: int
    n: int
    nnz: int
    d_tiling: DTiling
    segments: List[EllSegment]
    row_block: int
    plan_seconds: float
    fingerprint: str

    @property
    def padded_nnz(self) -> int:
        return sum(s.padded_nnz for s in self.segments)

    @property
    def efficiency(self) -> float:
        """real work / padded work — the balance metric the three
        strategies compete on (1.0 = perfectly balanced, no padding)."""
        return self.nnz / max(self.padded_nnz, 1)

    def stats(self) -> dict:
        return {
            "strategy": self.strategy,
            "segments": len(self.segments),
            "nnz": self.nnz,
            "padded_nnz": self.padded_nnz,
            "efficiency": round(self.efficiency, 4),
            "d_pad": self.d_tiling.d_pad,
            "dt": self.d_tiling.dt,
            "plan_seconds": self.plan_seconds,
        }


# ---------------------------------------------------------------------------
# Row grouping per strategy
# ---------------------------------------------------------------------------

def _group_row_split(row_ptr: np.ndarray) -> List[np.ndarray]:
    m = len(row_ptr) - 1
    return [np.arange(m, dtype=np.int64)]


def _group_nnz_split(row_ptr: np.ndarray, row_block: int = 8
                     ) -> List[np.ndarray]:
    lengths = np.diff(row_ptr)
    m = len(lengths)
    order = np.argsort(lengths, kind="stable")
    sorted_len = lengths[order]
    groups: List[np.ndarray] = []
    start = 0
    while start < m:
        lo = max(int(sorted_len[start]), 1)
        # geometric bucket: rows with length in [lo, 2*lo)
        end = int(np.searchsorted(sorted_len, 2 * lo, side="left"))
        end = max(end, start + 1)
        groups.append(order[start:end])
        start = end

    def padded_cost(rows) -> int:
        r_pad = -(-len(rows) // row_block) * row_block
        return r_pad * max(int(lengths[rows].max(initial=0)), 1)

    # coalesce: small buckets pay row_block padding; merge adjacent
    # (length-sorted) buckets whenever the merged padding is no worse
    merged = [groups[0]] if groups else []
    for g in groups[1:]:
        prev = merged[-1]
        cat = np.concatenate([prev, g])
        if padded_cost(cat) <= padded_cost(prev) + padded_cost(g):
            merged[-1] = cat
        else:
            merged.append(g)
    # guarantee: never worse than the single-segment (row_split) plan
    if merged:
        total = sum(padded_cost(g) for g in merged)
        everything = np.concatenate(merged)
        if padded_cost(everything) < total:
            merged = [everything]
    return merged


def _group_merge_split(row_ptr: np.ndarray, target_segments: int = 16
                       ) -> List[np.ndarray]:
    lengths = np.diff(row_ptr)
    m = len(lengths)
    total = m + int(lengths.sum())         # rows + nnz (merge-path length)
    quota = max(total // max(target_segments, 1), 1)
    # cumulative rows+nnz at each row boundary; cut at quota multiples
    cum = np.arange(1, m + 1) + np.cumsum(lengths)
    cuts = np.searchsorted(cum, quota * np.arange(1, target_segments))
    cuts = np.unique(np.clip(cuts, 0, m))
    bounds = np.concatenate([[0], cuts, [m]])
    bounds = np.unique(bounds)
    return [np.arange(bounds[i], bounds[i + 1], dtype=np.int64)
            for i in range(len(bounds) - 1) if bounds[i + 1] > bounds[i]]


# ---------------------------------------------------------------------------
# Plan construction
# ---------------------------------------------------------------------------

def build_plan(row_ptr: np.ndarray, col_indices: np.ndarray, shape,
               d: int, *, strategy: str = "nnz_split", row_block: int = 8,
               fingerprint: str = "", max_dt: int = 512,
               merge_target_segments: int = 16) -> SpmmPlan:
    t0 = time.perf_counter()
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    m, n = shape
    nnz = int(col_indices.shape[0])
    lengths = np.diff(row_ptr)

    if strategy == "row_split":
        groups = _group_row_split(row_ptr)
    elif strategy == "nnz_split":
        groups = _group_nnz_split(row_ptr, row_block)
    else:
        groups = _group_merge_split(row_ptr, merge_target_segments)

    d_tiling = plan_d_tiles(d, rows_in_flight=row_block, max_dt=max_dt)

    segments: List[EllSegment] = []
    for rows in groups:
        if rows.size == 0:
            continue
        L = int(lengths[rows].max(initial=0))
        Lp = max(L, 1)
        R = rows.size
        R_pad = -(-R // row_block) * row_block
        cols_pad = np.zeros((R_pad, Lp), dtype=np.int32)
        gather_idx = np.full((R_pad, Lp), nnz, dtype=np.int64)  # nnz -> 0.0
        # vectorized ELL packing (this is the measured "codegen" cost)
        starts = row_ptr[rows][:, None]                    # (R, 1)
        lens = lengths[rows][:, None]                      # (R, 1)
        lane = np.arange(Lp, dtype=np.int64)[None, :]      # (1, Lp)
        valid = lane < lens
        idx = starts + lane
        gather_idx[:R] = np.where(valid, idx, nnz)
        if nnz > 0:
            safe = np.minimum(idx, nnz - 1)
            cols_pad[:R] = np.where(valid, col_indices[safe], 0)
        segments.append(EllSegment(row_ids=rows, L=L, R_pad=R_pad,
                                   cols_pad=cols_pad, gather_idx=gather_idx))

    return SpmmPlan(strategy=strategy, m=m, n=n, nnz=nnz,
                    d_tiling=d_tiling, segments=segments,
                    row_block=row_block,
                    plan_seconds=time.perf_counter() - t0,
                    fingerprint=fingerprint)


# ---------------------------------------------------------------------------
# Fused workspace: all segments packed into ONE flat ELL buffer with a
# per-row-block descriptor table, so the whole plan lowers as a single
# pallas_call (the paper's one-artifact-per-instance claim, Table IV)
# instead of one dispatch per segment.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FusedEllWorkspace:
    """Descriptor-table packing of an :class:`SpmmPlan` or
    :class:`MixedPlan`.

    Every segment's ``(R_pad, L)`` ELL panel is flattened row-major and
    concatenated into one slot array; each row-block of ``row_block``
    rows gets a descriptor ``(blk_off, blk_L)`` locating its slots.  The
    kernel reads the descriptor from SMEM (scalar prefetch) — the TPU
    analogue of the paper baking per-instance bounds into the generated
    code — so one static grid covers blocks with heterogeneous ``L``.

    Mixed plans additionally tag each descriptor (``blk_tag``) with the
    execution unit it drives.  A VPU block's slots are the ``(bm, L)``
    ELL panel (one column id per slot, ``blk_coff == blk_off``); an MXU
    block-row's slots are its ``(K, bm, bk)`` value panels flattened,
    while its column stream carries only the ``K`` *block*-column ids —
    so the two streams diverge and each descriptor gets an independent
    column offset ``blk_coff``.  ``blk_L`` is the per-block loop trip
    count either way: padded nnz/row for VPU, block steps ``K`` (the
    per-block-row ``kmax``) for MXU.

    Workspace rows are ordered block-by-block (plan order), i.e. a
    permutation (plus padding rows) of the output rows; ``inv_perm``
    undoes it with a single gather: ``y = y_ws[inv_perm]``.

    DMA staging metadata (DESIGN.md §7.7): ``blk_span``/``blk_cspan``
    are each **merged trip's** contiguous slot/column footprint — with
    ``merge_width == 1`` (the default) that is the per-block extent:
    ``bm * L`` slots for a VPU block, ``L * bm * bk`` slots but only
    ``L`` column entries for an MXU block-row.  With ``merge_width ==
    W > 1`` (CGCM, DESIGN.md §7.9) each entry covers ``W`` consecutive
    descriptors and equals the sum of the member extents — valid
    because the packer emits both streams contiguously, so a merged
    trip's window is one contiguous ``[off[g*W], off[g*W] + span)``
    copy.  ``max_span``/``max_cspan`` round the per-trip maxima up to
    :data:`STAGE_TILE`, and the flat buffers are tail-padded with inert
    sentinels so the staged kernels can issue a fixed-size async copy
    for ANY merged trip without a bounds branch.

    CGCM merging pads the descriptor table to a multiple of
    ``merge_width`` with inert blocks (``blk_L == 0`` — zero trips,
    ``blk_off``/``blk_coff`` at the stream end, zero span) so the grid
    is exactly ``num_blocks // merge_width`` steps; the descriptor
    table itself is the merged trip's per-row segment table (each
    member keeps its own ``off``/``L``, so every row still reduces its
    lanes separately in-register and the output is bit-identical to
    the unmerged plan).
    """
    cols_flat: np.ndarray    # (Sc,) int32 — VPU: X row per slot;
                             #               MXU: block-column per step
    gather_flat: np.ndarray  # (S,) int64 — slot -> index in concat(vals,[0])
    blk_off: np.ndarray      # (B,) int32 — first slot of each row-block
    blk_L: np.ndarray        # (B,) int32 — loop trips (nnz/row or K)
    inv_perm: np.ndarray     # (m,) int32 — y[i] = y_ws[inv_perm[i]]
    ws_rows: int             # total workspace rows == B * row_block
    row_block: int
    blk_tag: Optional[np.ndarray] = None   # (B,) int32 VPU_TAG/MXU_TAG
    blk_coff: Optional[np.ndarray] = None  # (B,) int32 into cols_flat
    bk: int = 8              # MXU block width (block-column granularity)
    # staging metadata is ONLY produced by _pack_workspace, which also
    # tail-pads the flat streams to match — deriving windows for a
    # hand-built workspace would advertise staged-DMA safety its
    # buffers don't have, so there is deliberately no fallback here
    # (max_span == 0 means: no staged dispatch for this workspace)
    blk_span: Optional[np.ndarray] = None   # (B//W,) int32 slots per trip
    blk_cspan: Optional[np.ndarray] = None  # (B//W,) int32 cols per trip
    max_span: int = 0        # DMA window over gather/vals slots
    max_cspan: int = 0       # DMA window over cols entries
    merge_width: int = 1     # CGCM: descriptors per merged grid step
    pack_seconds: float = 0.0  # host cost of _pack_workspace (satellite
                               # of the Table IV amortization story)
    # the instance's nonzero count — the gather stream's sentinel value
    # and upper bound.  Stamped by _pack_workspace so a workspace is
    # self-describing to the static verifier (analysis/verify.py,
    # DESIGN.md §15); -1 means unknown (hand-built workspaces), and the
    # gather-bounds invariant is then skipped rather than guessed.
    nnz: int = -1

    def __post_init__(self):
        # pure-VPU packings (the pre-mixed layout): every block is VPU
        # and the column stream is slot-parallel, so coff == off
        if self.blk_tag is None:
            self.blk_tag = np.zeros_like(self.blk_L)
        if self.blk_coff is None:
            self.blk_coff = self.blk_off.copy()

    @property
    def num_blocks(self) -> int:
        return int(self.blk_off.shape[0])

    @property
    def num_trips(self) -> int:
        """Merged grid steps along the block axis — ``num_blocks`` when
        merging is off, ``num_blocks // merge_width`` under CGCM (the
        quantity the powerlaw bench asserts shrinks)."""
        return self.num_blocks // max(self.merge_width, 1)

    @property
    def has_mxu(self) -> bool:
        return bool(np.any(self.blk_tag == MXU_TAG))


def build_fused_workspace(plan, *, merge_width: int = 1
                          ) -> FusedEllWorkspace:
    """Pack a plan into the single-dispatch descriptor-table layout.

    Accepts either a pure-VPU :class:`SpmmPlan` (the original ELL
    layout: tags all ``VPU_TAG``, column stream slot-parallel) or a
    :class:`MixedPlan`, whose MXU block-rows join the same descriptor
    stream with ``MXU_TAG`` so the whole mixed plan still lowers as ONE
    ``pallas_call``.  ``merge_width`` is the CGCM width from the merge
    stage (:func:`choose_merge_width`); 1 reproduces the pre-CGCM
    layout byte-for-byte.
    """
    if isinstance(plan, MixedPlan):
        return _pack_workspace(plan, mixed_kernel=True,
                               merge_width=merge_width)
    # a pure-VPU SpmmPlan is the degenerate mixed plan (identity nnz
    # map, no MXU block-rows) — ONE packing loop serves both layouts,
    # so a packing-invariant fix can never diverge the two backends.
    # mixed_kernel=False skips the MXU-branch slot-stream floor, keeping
    # the ELL layout exactly slot-parallel (cols size == gather size).
    trivial = MixedPlan(
        strategy=plan.strategy, m=plan.m, n=plan.n, nnz=plan.nnz,
        d_tiling=plan.d_tiling, row_block=plan.row_block, bk=8,
        vpu=plan, vpu_rows=np.arange(plan.m, dtype=np.int64),
        vpu_nnz_map=np.arange(plan.nnz, dtype=np.int64),
        mxu_rows=[], plan_seconds=plan.plan_seconds,
        fingerprint=plan.fingerprint)
    return _pack_workspace(trivial, mixed_kernel=False,
                           merge_width=merge_width)


# the plan-transform pipeline's stage order (DESIGN.md §7.9); "shard"
# wraps the first four per chip range (build_sharded_workspace)
PLAN_STAGES = ("build", "merge", "tag", "pack", "shard")


@dataclasses.dataclass(frozen=True)
class SparseEinsumSpec:
    """What a fused sparse contraction asks of the plan pipeline.

    Every stage in :data:`PLAN_STAGES` consumes only the sparsity
    pattern — descriptor stream, slot packing, CGCM merging, per-chip
    DMA windows and sharding are identical whether the per-trip compute
    is ``y += a·x`` (SpMM) or the attention sandwich ``softmax(mask ⊙
    Q·Kᵀ)·V``.  The spec records the parts that DO differ so the
    dispatch layer can bind the right kernel body and build the right
    operand gathers (DESIGN.md §13):

    ``mixed``            run the tag stage (MXU block-rows join the
                         descriptor stream).
    ``row_operands``     dense operands indexed by the OUTPUT row (e.g.
                         attention's Q) — each needs a
                         :func:`workspace_row_map` gather into
                         workspace order before the kernel.
    ``col_operands``     dense operands indexed by the sparse column
                         (SpMM's X; attention's K and V) — addressed by
                         the shared column stream, no extra map.
    ``segment_softmax``  normalize each row segment in-register with a
                         running max/rescale across its trips.
    """
    name: str                       # kernel family: "spmm" | "sattn"
    mixed: bool = False
    row_operands: int = 0
    col_operands: int = 1
    segment_softmax: bool = False


SPMM_EINSUM = SparseEinsumSpec(name="spmm")
SPMM_MIXED_EINSUM = SparseEinsumSpec(name="spmm", mixed=True)
SPARSE_ATTN_EINSUM = SparseEinsumSpec(
    name="sattn", row_operands=1, col_operands=2, segment_softmax=True)
SPARSE_ATTN_MIXED_EINSUM = dataclasses.replace(
    SPARSE_ATTN_EINSUM, mixed=True)


def workspace_row_map(inv_perm, ws_rows: int) -> np.ndarray:
    """Forward permutation for row-indexed operands (DESIGN.md §13).

    ``inv_perm`` maps output row ``i`` to its workspace slot; this is
    the inverse view: ``row_map[j]`` is the output row that workspace
    slot ``j`` computes, or the sentinel ``m = len(inv_perm)`` on
    padding slots — callers append one zero row to the operand so the
    sentinel gathers zeros.  With it, an operand indexed by output row
    (attention's Q) is staged into workspace order by ONE host-free
    gather, the mirror of the ``y_ws[inv_perm]`` output gather.
    """
    inv = np.asarray(inv_perm, dtype=np.int64)
    m = int(inv.shape[0])
    row_map = np.full(int(ws_rows), m, dtype=np.int64)
    row_map[inv] = np.arange(m, dtype=np.int64)
    return row_map.astype(np.int32)


def sharded_workspace_row_maps(sw: "ShardedFusedWorkspace") -> np.ndarray:
    """Per-chip :func:`workspace_row_map` stack, shape (C, ws_rows).

    The sharded workspace's ``inv_perm`` is global over the flattened
    ``(C * ws_rows)`` workspace, so one flat map reshapes into the
    per-chip tables ``shard_map`` feeds each chip."""
    flat = workspace_row_map(sw.inv_perm, sw.n_chips * sw.ws_rows)
    return flat.reshape(sw.n_chips, sw.ws_rows)


def build_einsum_workspace(spec: SparseEinsumSpec, row_ptr: np.ndarray,
                           col_indices: np.ndarray, shape, d: int, *,
                           strategy: str = "nnz_split",
                           row_block: int = 8, bk: int = 8,
                           mxu_gain: float = 4.0,
                           merge_threshold: int = 0,
                           merge_width: Optional[int] = None,
                           fingerprint: str = "", max_dt: int = 512,
                           merge_target_segments: int = 16
                           ) -> FusedEllWorkspace:
    """Run the single-chip plan-transform pipeline end to end for any
    sparse einsum (DESIGN.md §13):

      merge  :func:`choose_merge_width` (skipped when ``merge_width``
             is pinned — the sharded path decides globally, the
             autotuner per candidate)
      build / tag  :func:`build_plan`, or :func:`build_mixed_plan`
             (``spec.mixed``) whose tag stage is
             :func:`tag_block_rows`
      pack   :func:`build_fused_workspace` → :func:`_pack_workspace`

    The spec only steers the tag stage here — the packed workspace is
    operand-agnostic by construction (it encodes the pattern, never the
    contraction), which is exactly why SpMM and sparse attention share
    it.  Every stage is also callable on its own; this wrapper is the
    canonical composition the dispatch layer and the benches use.
    """
    if merge_width is None:
        merge_width = choose_merge_width(
            row_ptr, row_block=row_block, merge_threshold=merge_threshold)
    if spec.mixed:
        plan = build_mixed_plan(
            row_ptr, col_indices, shape, d, strategy=strategy,
            row_block=row_block, bk=bk, mxu_gain=mxu_gain,
            fingerprint=fingerprint, max_dt=max_dt,
            merge_target_segments=merge_target_segments)
    else:
        plan = build_plan(
            row_ptr, col_indices, shape, d, strategy=strategy,
            row_block=row_block, fingerprint=fingerprint, max_dt=max_dt,
            merge_target_segments=merge_target_segments)
    return build_fused_workspace(plan, merge_width=merge_width)


def build_workspace(row_ptr: np.ndarray, col_indices: np.ndarray, shape,
                    d: int, *, strategy: str = "nnz_split",
                    row_block: int = 8, mixed: bool = False, bk: int = 8,
                    mxu_gain: float = 4.0, merge_threshold: int = 0,
                    merge_width: Optional[int] = None,
                    fingerprint: str = "", max_dt: int = 512,
                    merge_target_segments: int = 16
                    ) -> FusedEllWorkspace:
    """The SpMM specialization of :func:`build_einsum_workspace` —
    kept as the historical entry point for ``A·X`` callers."""
    spec = SPMM_MIXED_EINSUM if mixed else SPMM_EINSUM
    return build_einsum_workspace(
        spec, row_ptr, col_indices, shape, d, strategy=strategy,
        row_block=row_block, bk=bk, mxu_gain=mxu_gain,
        merge_threshold=merge_threshold, merge_width=merge_width,
        fingerprint=fingerprint, max_dt=max_dt,
        merge_target_segments=merge_target_segments)


# ---------------------------------------------------------------------------
# Mixed VPU/MXU plans: per-row-block execution-unit selection.  The MXU
# (128x128 systolic array) is where TPU FLOPs live, but a (bm x bk)
# block matmul on a nearly-empty block wastes bk x the VPU's work — so
# each bm-aligned block-row is tagged at plan time by comparing its
# padded MXU work (K * bm * bk MACs per output column) against its
# padded VPU work (Lmax * bm), discounted by the MXU's throughput edge.
# VPU-tagged rows then flow through the usual strategy-driven ELL
# grouping; MXU block-rows keep their natural (block-aligned) order.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MxuBlockRow:
    """One bm-aligned block-row lowered as K (bm x bk) block matmuls."""
    row0: int                # first original row (multiple of row_block)
    nrows: int               # real rows covered (< row_block on the tail)
    bcols: np.ndarray        # (K,) int32 — occupied block-column ids
    gather: np.ndarray       # (K, bm, bk) int64 into concat(vals,[0])

    @property
    def K(self) -> int:
        return int(self.bcols.shape[0])


@dataclasses.dataclass
class MixedPlan:
    """Workload division across BOTH execution units (tentpole of the
    BCSR-fusion PR): VPU rows carry an ordinary :class:`SpmmPlan` built
    on their sub-structure, MXU rows a list of :class:`MxuBlockRow`.
    ``build_fused_workspace`` packs both into one descriptor stream.
    """
    strategy: str
    m: int
    n: int
    nnz: int
    d_tiling: DTiling
    row_block: int
    bk: int
    vpu: SpmmPlan            # ELL plan over vpu_rows (local row ids)
    vpu_rows: np.ndarray     # (mv,) int64 original row ids (ascending)
    vpu_nnz_map: np.ndarray  # (sub_nnz,) int64 global nnz id per sub nnz
    mxu_rows: List[MxuBlockRow]
    plan_seconds: float
    fingerprint: str

    @property
    def padded_nnz(self) -> int:
        """Padded MACs per output column: bm*L per VPU block plus
        bm*bk*K per MXU block-row — the mixed-balance metric."""
        vpu = self.vpu.padded_nnz
        mxu = sum(b.K * self.row_block * self.bk for b in self.mxu_rows)
        return vpu + mxu

    @property
    def efficiency(self) -> float:
        return self.nnz / max(self.padded_nnz, 1)

    @property
    def mxu_share(self) -> float:
        """Fraction of nonzeros routed to the MXU (1.0 = pure BCSR)."""
        sub_nnz = int(self.vpu_nnz_map.shape[0])
        return (self.nnz - sub_nnz) / max(self.nnz, 1)

    def stats(self) -> dict:
        return {
            "strategy": self.strategy,
            "vpu_segments": len(self.vpu.segments),
            "mxu_block_rows": len(self.mxu_rows),
            "nnz": self.nnz,
            "padded_nnz": self.padded_nnz,
            "efficiency": round(self.efficiency, 4),
            "mxu_share": round(self.mxu_share, 4),
            "plan_seconds": self.plan_seconds,
        }


def tag_block_rows(row_ptr: np.ndarray, col_indices: np.ndarray, shape,
                   *, row_block: int = 8, bk: int = 8,
                   mxu_gain: float = 4.0):
    """The **tag** stage of the plan pipeline: assign each bm-aligned
    block-row its execution unit.

    A block-row goes MXU when ``K * bk <= mxu_gain * Lmax`` — its padded
    matmul work, discounted by the MXU's per-MAC throughput advantage
    ``mxu_gain``, beats the ELL path's padded FMA work.  ``mxu_gain=0``
    forces a pure-VPU plan; ``mxu_gain=inf`` a pure-BCSR one.  Dense or
    block-clustered regions go MXU, ragged sparse rows stay VPU.

    Returns ``(mxu_rows, vpu_rows)``: the packed
    :class:`MxuBlockRow` list and the (ascending) original row ids left
    on the VPU path.
    """
    row_ptr = np.asarray(row_ptr)
    col_indices = np.asarray(col_indices)
    m, _ = shape
    nnz = int(col_indices.shape[0])
    lengths = np.diff(row_ptr)
    bm = row_block

    mxu_rows: List[MxuBlockRow] = []
    vpu_row_parts: List[np.ndarray] = []
    for g in range(-(-m // bm) if m else 0):
        r0, r1 = g * bm, min((g + 1) * bm, m)
        s, e = int(row_ptr[r0]), int(row_ptr[r1])
        if s == e:                       # empty block-row: VPU is free
            vpu_row_parts.append(np.arange(r0, r1, dtype=np.int64))
            continue
        cols = col_indices[s:e]
        bcols = np.unique(cols // bk)
        Lmax = int(lengths[r0:r1].max(initial=0))
        if bcols.size * bk > mxu_gain * Lmax:
            vpu_row_parts.append(np.arange(r0, r1, dtype=np.int64))
            continue
        # pack the block-row: one (bm, bk) gather panel per block-column
        rr = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                       lengths[r0:r1])
        kpos = np.searchsorted(bcols, cols // bk)
        gather = np.full((bcols.size, bm, bk), nnz, dtype=np.int64)
        gather[kpos, rr, cols % bk] = np.arange(s, e, dtype=np.int64)
        mxu_rows.append(MxuBlockRow(row0=r0, nrows=r1 - r0,
                                    bcols=bcols.astype(np.int32),
                                    gather=gather))

    vpu_rows = (np.concatenate(vpu_row_parts) if vpu_row_parts
                else np.zeros(0, dtype=np.int64))
    return mxu_rows, vpu_rows


def build_mixed_plan(row_ptr: np.ndarray, col_indices: np.ndarray, shape,
                     d: int, *, strategy: str = "nnz_split",
                     row_block: int = 8, bk: int = 8,
                     mxu_gain: float = 4.0, fingerprint: str = "",
                     max_dt: int = 512,
                     merge_target_segments: int = 16) -> MixedPlan:
    """Tag each bm-aligned block-row VPU or MXU and plan both halves —
    the tag+build composition of the plan pipeline (the tagging
    heuristic itself lives in :func:`tag_block_rows`)."""
    t0 = time.perf_counter()
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}")
    row_ptr = np.asarray(row_ptr)
    col_indices = np.asarray(col_indices)
    m, n = shape
    nnz = int(col_indices.shape[0])
    lengths = np.diff(row_ptr)
    bm = row_block

    mxu_rows, vpu_rows = tag_block_rows(
        row_ptr, col_indices, shape, row_block=bm, bk=bk,
        mxu_gain=mxu_gain)
    # sub-structure of the VPU rows (original relative order) plus the
    # map from sub-nnz ids back to global nnz ids for gather re-basing
    sub_lengths = lengths[vpu_rows]
    sub_ptr = np.zeros(vpu_rows.size + 1, dtype=np.int64)
    np.cumsum(sub_lengths, out=sub_ptr[1:])
    sub_nnz = int(sub_ptr[-1])
    starts = row_ptr[vpu_rows]
    nnz_map = (np.repeat(starts, sub_lengths)
               + np.arange(sub_nnz, dtype=np.int64)
               - np.repeat(sub_ptr[:-1], sub_lengths))
    sub_cols = col_indices[nnz_map] if sub_nnz else np.zeros(0, np.int32)

    vpu_plan = build_plan(sub_ptr, sub_cols, (vpu_rows.size, n), d,
                          strategy=strategy, row_block=bm,
                          fingerprint=f"{fingerprint}/vpu",
                          max_dt=max_dt,
                          merge_target_segments=merge_target_segments)

    return MixedPlan(strategy=strategy, m=m, n=n, nnz=nnz,
                     d_tiling=vpu_plan.d_tiling, row_block=bm, bk=bk,
                     vpu=vpu_plan, vpu_rows=vpu_rows, vpu_nnz_map=nnz_map,
                     mxu_rows=mxu_rows,
                     plan_seconds=time.perf_counter() - t0,
                     fingerprint=fingerprint)


def _pack_workspace(plan: MixedPlan, *, mixed_kernel: bool,
                    merge_width: int = 1) -> FusedEllWorkspace:
    """Pack a :class:`MixedPlan` into one tagged descriptor stream —
    THE packing loop, shared by both fused backends (pure-VPU plans
    arrive as degenerate mixed plans, see ``build_fused_workspace``).

    VPU blocks first (plan order, gather remapped from sub-nnz to global
    nnz ids), then the MXU block-rows.  Column and slot streams advance
    independently (see :class:`FusedEllWorkspace`).  ``mixed_kernel``
    marks workspaces destined for ``spmm_bcsr_fused`` (identity remap
    skipped only when False, and the slot-stream floor applied only
    when True — the pure ELL kernel needs neither).

    ``merge_width == W > 1`` (CGCM, DESIGN.md §7.9) pads the descriptor
    table to a multiple of ``W`` with inert zero-trip blocks and emits
    PER-MERGED-TRIP spans (each the sum of its ``W`` members' extents —
    both streams are contiguous across consecutive descriptors, so a
    merged trip is still one contiguous DMA window).
    """
    t_pack0 = time.perf_counter()
    mw = max(int(merge_width), 1)
    bm = plan.row_block
    nnz = plan.nnz
    sub_nnz = int(plan.vpu_nnz_map.shape[0])
    cols_parts: List[np.ndarray] = []
    gather_parts: List[np.ndarray] = []
    tags: List[int] = []
    offs: List[int] = []
    coffs: List[int] = []
    Ls: List[int] = []
    spans: List[int] = []
    cspans: List[int] = []
    inv_perm = np.zeros(plan.m, dtype=np.int32)
    ws_row = 0
    slot = 0
    cpos = 0
    for seg in plan.vpu.segments:
        Lp = max(seg.L, 1)
        cols_parts.append(seg.cols_pad.reshape(-1))
        # sub-nnz ids -> global nnz ids; the sub sentinel becomes global
        g = seg.gather_idx.reshape(-1)
        if not mixed_kernel:
            # degenerate wrap: the nnz map is the identity by
            # construction, so the plan's gather ids ARE global
            gather_parts.append(g)
        elif sub_nnz == 0:        # all-empty VPU rows: pure sentinel
            gather_parts.append(np.full(g.shape, nnz, np.int64))
        else:
            safe = np.minimum(g, sub_nnz - 1)
            gather_parts.append(
                np.where(g < sub_nnz, plan.vpu_nnz_map[safe], nnz))
        nblk = seg.R_pad // bm
        for b in range(nblk):
            tags.append(VPU_TAG)
            offs.append(slot + b * bm * Lp)
            coffs.append(cpos + b * bm * Lp)
            Ls.append(Lp)
            spans.append(bm * Lp)
            cspans.append(bm * Lp)
        inv_perm[plan.vpu_rows[seg.row_ids]] = (
            ws_row + np.arange(seg.R, dtype=np.int32))
        ws_row += seg.R_pad
        slot += seg.R_pad * Lp
        cpos += seg.R_pad * Lp
    for blk in plan.mxu_rows:
        tags.append(MXU_TAG)
        offs.append(slot)
        coffs.append(cpos)
        Ls.append(blk.K)
        spans.append(blk.K * bm * plan.bk)
        cspans.append(blk.K)
        cols_parts.append(blk.bcols)
        gather_parts.append(blk.gather.reshape(-1))
        inv_perm[blk.row0:blk.row0 + blk.nrows] = (
            ws_row + np.arange(blk.nrows, dtype=np.int32))
        ws_row += bm
        slot += blk.K * bm * plan.bk
        cpos += blk.K

    assert slot < (1 << 31), ("mixed workspace exceeds int32 slot space",
                              slot)

    # CGCM (DESIGN.md §7.9): pad the descriptor table to a multiple of
    # the merge width with inert blocks — zero trips, zero span, offsets
    # at the stream end — so the grid is exactly num_blocks // W merged
    # steps and a partially-filled final trip reads nothing extra.  The
    # pad blocks cost bm zero output rows each (inv_perm never points at
    # them), bounded by (W - 1) * bm rows total.
    while len(Ls) % mw:
        tags.append(VPU_TAG)
        offs.append(slot)
        coffs.append(cpos)
        Ls.append(0)
        spans.append(0)
        cspans.append(0)
        ws_row += bm

    # fixed-size DMA windows for the staged kernels (DESIGN.md §7.7):
    # every merged trip's panel copy is [off, off + max_span) whatever
    # its own span, so the flat streams get a max-window tail of inert
    # sentinels (gather -> the zero slot, cols -> row/block-column 0).
    # Per-trip spans are the sum over the trip's W members (contiguous
    # streams make that the exact contiguous footprint); W == 1 keeps
    # the historical per-block arrays byte-for-byte.
    trip_spans = np.asarray(spans, np.int64).reshape(-1, mw).sum(axis=1)
    trip_cspans = np.asarray(cspans, np.int64).reshape(-1, mw).sum(axis=1)
    max_span = _stage_tile_ceil(trip_spans.max(initial=0))
    max_cspan = _stage_tile_ceil(trip_cspans.max(initial=0))

    def cat(parts, dtype, floor, min_size, tail):
        out = (np.concatenate(parts).astype(dtype) if parts
               else np.zeros(0, dtype))
        if out.size < min_size and tags and mixed_kernel:
            # the mixed kernel traces BOTH units (lax.cond), so the slot
            # stream must admit the MXU branch's (bm*bk,) slice even on
            # tiny or pure-VPU plans; inert sentinel entries pad it up
            # (zero-length operands don't block-spec either)
            pad = np.full(min_size - out.size, floor, dtype)
            out = np.concatenate([out, pad])
        if tail:
            out = np.concatenate([out, np.full(tail, floor, dtype)])
        return out

    ws = FusedEllWorkspace(
        cols_flat=cat(cols_parts, np.int32, 0, 1, max_cspan),
        gather_flat=cat(gather_parts, np.int64, nnz, bm * plan.bk,
                        max_span),
        blk_off=np.asarray(offs, np.int32),
        blk_L=np.asarray(Ls, np.int32),
        inv_perm=inv_perm,
        ws_rows=ws_row,
        row_block=bm,
        blk_tag=np.asarray(tags, np.int32),
        blk_coff=np.asarray(coffs, np.int32),
        bk=plan.bk,
        blk_span=trip_spans.astype(np.int32),
        blk_cspan=trip_cspans.astype(np.int32),
        max_span=max_span,
        max_cspan=max_cspan,
        merge_width=mw,
        pack_seconds=time.perf_counter() - t_pack0,
        nnz=nnz)
    assert ws.ws_rows == ws.num_blocks * bm
    assert ws.num_blocks % mw == 0
    return ws


# ---------------------------------------------------------------------------
# Chip-level partitioning (multi-chip SpMM; DESIGN.md §7.6) — the same
# three strategies applied at the shard_map level: returns row boundaries
# (row-aligned) assigning each chip a contiguous row range.
# ---------------------------------------------------------------------------

def partition_rows_for_chips(row_ptr: np.ndarray, n_chips: int,
                             strategy: str = "nnz_split", *,
                             align: int = 1) -> np.ndarray:
    """Chip row boundaries by the given strategy.

    ``align`` rounds the interior bounds to multiples of that many rows
    — the BCSR/mixed path passes its ``row_block`` so chips own whole
    block-rows and no (bm x bk) block ever straddles a chip (the final
    bound stays ``m``; the ragged tail pads inside its own chip).
    """
    m = len(row_ptr) - 1
    nnz = int(row_ptr[-1])
    if strategy == "row_split":
        bounds = np.linspace(0, m, n_chips + 1).astype(np.int64)
    elif strategy == "nnz_split":
        targets = nnz * np.arange(1, n_chips) / n_chips
        bounds = np.concatenate(
            [[0], np.searchsorted(row_ptr[1:], targets, side="left") + 1, [m]])
    elif strategy == "merge_split":
        cum = np.arange(1, m + 1) + np.asarray(row_ptr[1:])
        total = m + nnz
        targets = total * np.arange(1, n_chips) / n_chips
        bounds = np.concatenate([[0], np.searchsorted(cum, targets), [m]])
    else:
        raise ValueError(strategy)
    bounds = np.clip(bounds.astype(np.int64), 0, m)
    if align > 1:
        bounds[1:-1] = ((bounds[1:-1] + align // 2) // align) * align
        bounds = np.clip(bounds, 0, m)
    bounds = np.maximum.accumulate(bounds)
    # degenerate-shard clamp: rounding (or a hot head row) can leave a
    # chip empty while LATER chips still hold rows — e.g. align=8 on a
    # single block-row used to give [0, 0, 8, 8] (chip 0 empty, chip 1
    # everything).  Every chip before the end of the matrix gets at
    # least one align-unit (the tail block-row may be ragged); surplus
    # chips drain to empty ranges AT THE END, never in the middle.
    for i in range(1, n_chips):
        if bounds[i] <= bounds[i - 1] and bounds[i - 1] < m:
            bounds[i] = min(bounds[i - 1] + align, m)
    return np.maximum.accumulate(bounds)


# ---------------------------------------------------------------------------
# Sharded fused workspace: one FusedEllWorkspace per chip row range,
# padded to common block/slot counts so the whole table ships as stacked
# (n_chips, ...) arrays under shard_map — each chip then runs its shard
# as ONE pallas_call, the multi-chip extension of the fused dispatch.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedFusedWorkspace:
    """Per-chip descriptor tables for the multi-chip fused dispatch.

    ``partition_rows_for_chips`` assigns chip ``c`` the contiguous row
    range ``[bounds[c], bounds[c+1])``; each range is re-planned with the
    same strategy (a slice of ``row_ptr``/``col_indices`` re-based by
    ``row_ptr[bounds[c]]``) and packed with
    :func:`build_fused_workspace`.  Because descriptors are offset-
    relative, re-basing the per-chip ``gather`` indices into the GLOBAL
    ``concat(vals, [0])`` buffer is a single offset addition (padding
    slots keep the global ``nnz`` zero sentinel).

    All chips are padded to a common block count ``B`` (pad descriptors
    carry ``blk_L == 0`` — zero loop trips, zero output rows) and slot
    count ``S``, so the stacked arrays are rectangular and shard cleanly
    over a 1-D ``("chips",)`` mesh.  ``inv_perm`` is global: output row
    ``i`` lives at row ``inv_perm[i]`` of the flattened
    ``(n_chips * ws_rows, d)`` workspace output.

    DMA windows are PER CHIP (``chip_span``/``chip_cspan``): each chip's
    staged scratch ring is sized from its own largest block, so one hot
    shard (all-nnz-in-one-row) no longer inflates every chip's VMEM ring
    and stream tail to the cross-chip max.  The stacking stays
    rectangular for shard_map (``S = max_c(real_slots_c + span_c)``),
    and the dispatch layer specializes the staged kernel per distinct
    window (``lax.switch`` on the chip axis index) — still exactly one
    ``pallas_call`` executed per chip.  ``max_span``/``max_cspan`` keep
    the cross-chip maxima for introspection and the unsharded contract.

    Cross-chip X sharding (``x_sharding="rows"``): X rows are split into
    ``bk``-row panels owned contiguously by chips (chip ``c`` owns
    panels ``[c*x_own_panels, (c+1)*x_own_panels)``), and the planner
    derives each chip's TOUCHED panel set from its descriptor stream —
    the same AOT-vs-JIT information gap the paper exploits for
    registers, applied to placement.  ``cols_flat`` is then remapped
    into each chip's compact local panel space, and the fetch tables
    drive a plan-time exact-panel exchange (DESIGN.md §7.8):

      x_fetch[c, t]    global panel id of chip c's t-th local panel
                       (sorted; padded by panel 0),
      x_send[c, j, t]  owner-local panel ids chip c sends chip j,
      x_recv[c, t]     flat index into chip c's (C*T2,) received-panel
                       buffer for local panel t.

    ``x_sharding="replicated"`` leaves all of these empty and keeps the
    PR 2 layout (X replicated per chip, cols global).
    """
    blk_off: np.ndarray      # (C, B) int32 — first slot per row-block
    blk_L: np.ndarray        # (C, B) int32 — loop trips (0 == pad block)
    cols_flat: np.ndarray    # (C, Sc) int32 — slot -> X row / block-column
    gather_flat: np.ndarray  # (C, S) int64 — slot -> GLOBAL concat(vals,[0])
    inv_perm: np.ndarray     # (m,) int32 into the flattened (C*ws_rows,) rows
    bounds: np.ndarray       # (C+1,) int64 — chip c owns rows [b[c], b[c+1])
    ws_rows: int             # per-chip workspace rows == B * row_block
    row_block: int
    n_chips: int
    shard_plans: List       # per-chip SpmmPlan/MixedPlan (stats/debug)
    blk_tag: Optional[np.ndarray] = None   # (C, B) int32 VPU_TAG/MXU_TAG
    blk_coff: Optional[np.ndarray] = None  # (C, B) int32 into cols_flat
    bk: int = 8
    max_span: int = 0        # cross-chip max DMA window over slots
    max_cspan: int = 0       # cross-chip max DMA window over cols entries
    chip_span: Optional[np.ndarray] = None   # (C,) int32 per-chip window
    chip_cspan: Optional[np.ndarray] = None  # (C,) int32 per-chip window
    # cross-chip X fetch schedule (x_sharding="rows"; DESIGN.md §7.8)
    x_sharding: str = "replicated"
    x_panels: int = 0        # global bk-row X panels (ceil(n_pad / bk))
    x_own_panels: int = 0    # panels owned per chip (contiguous split)
    x_fetch: Optional[np.ndarray] = None  # (C, T) int32 global panel ids
    x_send: Optional[np.ndarray] = None   # (C, C, T2) int32 local panels
    x_recv: Optional[np.ndarray] = None   # (C, T) int32 into (C*T2,) recv
    # CGCM (DESIGN.md §7.9): decided ONCE from the global row_ptr before
    # partitioning, so every chip packs with the same width and chip
    # bounds cut at merged-trip boundaries
    merge_width: int = 1
    pack_seconds: float = 0.0  # summed host cost of the per-chip packs

    def __post_init__(self):
        if self.blk_tag is None:
            self.blk_tag = np.zeros_like(self.blk_L)
        if self.blk_coff is None:
            self.blk_coff = self.blk_off.copy()
        if self.chip_span is None:
            self.chip_span = np.full(self.n_chips, self.max_span, np.int32)
        if self.chip_cspan is None:
            self.chip_cspan = np.full(self.n_chips, self.max_cspan,
                                      np.int32)

    @property
    def num_blocks(self) -> int:
        """Common per-chip block count B (0 iff the matrix has no rows)."""
        return int(self.blk_off.shape[1])

    @property
    def num_trips(self) -> int:
        """Per-chip merged grid steps along the block axis."""
        return self.num_blocks // max(self.merge_width, 1)

    @property
    def x_local_panels(self) -> int:
        """Per-chip local X panel count T (x_sharding="rows" only)."""
        return 0 if self.x_fetch is None else int(self.x_fetch.shape[1])

    @property
    def has_mxu(self) -> bool:
        return bool(np.any(self.blk_tag == MXU_TAG))

    @property
    def nnz(self) -> int:
        return sum(p.nnz for p in self.shard_plans)

    @property
    def padded_nnz(self) -> int:
        """Real per-chip padded work (pad blocks run zero trips, so they
        are excluded — this is what each chip's trip loops execute).  An
        MXU block's trip covers a (bm x bk) panel, a VPU trip bm rows."""
        L = self.blk_L.astype(np.int64)
        per_trip = np.where(self.blk_tag == MXU_TAG, self.bk, 1)
        return int(self.row_block * (L * per_trip).sum())

    @property
    def efficiency(self) -> float:
        """nnz / padded work across all chips — same balance metric as
        :attr:`SpmmPlan.efficiency`, now including shard imbalance."""
        return self.nnz / max(self.padded_nnz, 1)


def _chip_x_panels(ws: FusedEllWorkspace, real_cols: int, bk: int):
    """Per-entry X panel ids (and the MXU-entry mask) for one chip's
    real column stream.

    A VPU slot names an X row ``k`` (panel ``k // bk``); an MXU column
    entry IS a block-column id, i.e. already a panel id (the MXU X panel
    is exactly rows ``[bc*bk, bc*bk + bk)``).  Sentinel entries are 0,
    so panel 0 is force-included — every remapped id stays in bounds.
    """
    cols = ws.cols_flat[:real_cols].astype(np.int64)
    mxu_entry = np.zeros(real_cols, bool)
    for tag, coff, L in zip(ws.blk_tag, ws.blk_coff, ws.blk_L):
        if tag == MXU_TAG:
            mxu_entry[coff:coff + L] = True
    pan = np.where(mxu_entry, cols, cols // bk)
    return pan, mxu_entry


@dataclasses.dataclass
class StackedFusedTables:
    """Rectangular stacking of K per-member fused workspaces — the
    shared trick behind BOTH stacking axes: chips
    (:class:`ShardedFusedWorkspace`) and serving requests
    (:class:`BatchedFusedWorkspace`, DESIGN.md §12).

    Each member's descriptor table is padded to the common block count
    ``B`` (pad blocks: ``L == 0``, zero trips) and its flat slot/column
    streams to common widths ``S``/``Sc``.  Offsets stay member-
    relative — a consumer re-bases them per axis — and the gather
    stream is re-based here to ONE global ``concat(vals, [0])`` buffer
    (each member's local zero sentinel becomes ``global_nnz``).
    """
    blk_off: np.ndarray      # (K, B) int32 — member-relative slot offset
    blk_L: np.ndarray        # (K, B) int32 — pad blocks: L == 0
    blk_tag: np.ndarray      # (K, B) int32
    blk_coff: np.ndarray     # (K, B) int32 — member-relative cols offset
    cols_flat: np.ndarray    # (K, Sc) int32
    gather_flat: np.ndarray  # (K, S) int64 -> global concat(vals,[0])
    member_span: np.ndarray  # (K,) int32 per-member staged slot window
    member_cspan: np.ndarray  # (K,) int32 per-member staged cols window
    num_blocks: int          # common per-member block count B
    ws_rows: int             # per-member workspace rows B * row_block


def stack_fused_workspaces(members: List[FusedEllWorkspace], *,
                           member_nnz: List[int], nnz_bases: List[int],
                           global_nnz: int, merge_width: int = 1,
                           row_block: int = 8, cols_map=None,
                           uniform_windows: bool = False
                           ) -> StackedFusedTables:
    """Stack K fused workspaces into rectangular ``(K, ·)`` tables.

    ``cols_map(k, ws, cols)`` optionally rewrites member ``k``'s real
    column entries before padding (the x-sharded chip remap, the
    batched request re-base).

    ``uniform_windows=True`` sizes every member's staged-DMA window at
    the cross-member max and widens the streams so ANY member offset
    plus that window stays inside the member's own row — required when
    the stacked tables are flattened into ONE dispatch with a single
    static window (the request axis, DESIGN.md §12).  The chip axis
    keeps per-member windows instead (the PR 5 hot-shard fix): each
    chip's ring is sized from ITS OWN largest trip, floored at one
    :data:`STAGE_TILE` so an empty member's (SPMD-replicated) window
    copies stay non-degenerate.
    """
    # every member's block count is a multiple of W (the packer pads),
    # so the common stacked count is too — stacked pad blocks (L == 0,
    # off == 0) only ever fill whole merged trips at the tail
    K = len(members)
    B = max(ws.num_blocks for ws in members)
    assert B % max(merge_width, 1) == 0
    real_s = [int(ws.gather_flat.shape[0]) - ws.max_span
              for ws in members]
    real_c = [int(ws.cols_flat.shape[0]) - ws.max_cspan
              for ws in members]
    member_span = np.asarray(
        [max(ws.max_span, STAGE_TILE) for ws in members], np.int32)
    member_cspan = np.asarray(
        [max(ws.max_cspan, STAGE_TILE) for ws in members], np.int32)
    if uniform_windows:
        member_span[:] = member_span.max()
        member_cspan[:] = member_cspan.max()
    S = max(r + int(s) for r, s in zip(real_s, member_span))
    Sc = max(r + int(s) for r, s in zip(real_c, member_cspan))
    blk_off = np.zeros((K, B), np.int32)
    blk_L = np.zeros((K, B), np.int32)       # pad blocks: L == 0
    blk_tag = np.zeros((K, B), np.int32)
    blk_coff = np.zeros((K, B), np.int32)
    cols_flat = np.zeros((K, Sc), np.int32)
    # pad -> the global 0.0 value sentinel
    gather_flat = np.full((K, S), global_nnz, np.int64)
    for k, ws in enumerate(members):
        nb = ws.num_blocks
        blk_off[k, :nb] = ws.blk_off
        blk_L[k, :nb] = ws.blk_L
        blk_tag[k, :nb] = ws.blk_tag
        blk_coff[k, :nb] = ws.blk_coff
        cols = ws.cols_flat[:real_c[k]]
        if cols_map is not None:
            cols = cols_map(k, ws, cols)
        cols_flat[k, :real_c[k]] = cols
        # re-base member-local value indices to the global vals buffer;
        # the member's zero sentinel (its local nnz) becomes the global
        g = ws.gather_flat[:real_s[k]]
        gather_flat[k, :real_s[k]] = np.where(
            g < member_nnz[k], g + nnz_bases[k], global_nnz)
    return StackedFusedTables(
        blk_off=blk_off, blk_L=blk_L, blk_tag=blk_tag, blk_coff=blk_coff,
        cols_flat=cols_flat, gather_flat=gather_flat,
        member_span=member_span, member_cspan=member_cspan,
        num_blocks=B, ws_rows=B * row_block)


def build_sharded_workspace(row_ptr: np.ndarray, col_indices: np.ndarray,
                            shape, d: int, *, n_chips: int,
                            strategy: str = "nnz_split", row_block: int = 8,
                            fingerprint: str = "", max_dt: int = 512,
                            merge_target_segments: int = 16,
                            backend: str = "pallas_ell", bk: int = 8,
                            mxu_gain: float = 4.0,
                            x_sharding: str = "replicated",
                            merge_threshold: int = 0
                            ) -> ShardedFusedWorkspace:
    """Partition rows across ``n_chips`` and pack one fused workspace per
    chip (see :class:`ShardedFusedWorkspace`).  Host-only — needs no
    devices; the mesh enters at dispatch time.

    ``backend="pallas_bcsr"`` plans each chip range as a mixed VPU/MXU
    plan (see :func:`build_mixed_plan`) and aligns the chip boundaries
    to ``row_block`` so the partitioner sees block-row — not scalar-row
    — boundaries and no (bm x bk) block straddles a chip.

    ``x_sharding="rows"`` additionally splits X into ``bk``-row panels
    owned contiguously by chips, remaps each chip's column stream into
    its compact touched-panel space, and emits the fetch/send/recv
    tables the dispatch layer's exact-panel exchange consumes
    (DESIGN.md §7.8) — instance size then scales with the mesh instead
    of one chip's HBM.

    ``merge_threshold`` drives the CGCM merge stage (DESIGN.md §7.9).
    The width is chosen ONCE from the GLOBAL ``row_ptr`` — the shard
    stage runs AFTER merge in the pipeline — and the chip bounds are
    aligned to ``row_block * W`` rows so every chip's block count is a
    whole number of merged trips and no merged trip straddles a chip.
    """
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if x_sharding not in ("replicated", "rows"):
        raise ValueError(
            f"x_sharding must be 'replicated' or 'rows', got {x_sharding!r}")
    mixed = backend == "pallas_bcsr"
    row_ptr = np.asarray(row_ptr)
    col_indices = np.asarray(col_indices)
    m, n = shape
    nnz = int(col_indices.shape[0])
    # merge BEFORE partitioning (pipeline order: ... merge → ... →
    # shard): one global width, chip cuts at merged-trip boundaries
    merge_width = choose_merge_width(row_ptr, row_block=row_block,
                                     merge_threshold=merge_threshold)
    align = 1 if (not mixed and merge_width == 1) else (row_block
                                                        * merge_width)
    bounds = partition_rows_for_chips(row_ptr, n_chips, strategy,
                                      align=align)

    plans: List = []
    shards: List[FusedEllWorkspace] = []
    bases: List[int] = []
    for c in range(n_chips):
        r0, r1 = int(bounds[c]), int(bounds[c + 1])
        base = int(row_ptr[r0])
        sub_ptr = row_ptr[r0:r1 + 1] - base
        sub_cols = col_indices[base:int(row_ptr[r1])]
        if mixed:
            plan = build_mixed_plan(
                sub_ptr, sub_cols, (r1 - r0, n), d, strategy=strategy,
                row_block=row_block, bk=bk, mxu_gain=mxu_gain,
                fingerprint=f"{fingerprint}/chip{c}", max_dt=max_dt,
                merge_target_segments=merge_target_segments)
        else:
            plan = build_plan(sub_ptr, sub_cols, (r1 - r0, n), d,
                              strategy=strategy, row_block=row_block,
                              fingerprint=f"{fingerprint}/chip{c}",
                              max_dt=max_dt,
                              merge_target_segments=merge_target_segments)
        plans.append(plan)
        shards.append(build_fused_workspace(plan,
                                            merge_width=merge_width))
        bases.append(base)

    needs: List[np.ndarray] = []
    x_panels = max(-(-int(n) // bk), 1)

    def _xshard_cols_map(c, ws, chip_cols):
        # remap this chip's column stream into its compact local panel
        # space: global row k -> local_panel(k//bk)*bk + k%bk for VPU
        # slots, global block-column -> local panel for MXU entries
        # (sentinel 0 stays 0: panel 0 is always fetched)
        pan, mxu_entry = _chip_x_panels(ws, chip_cols.shape[0], bk)
        need = np.unique(np.concatenate([np.zeros(1, np.int64), pan]))
        lut = np.zeros(x_panels, np.int64)
        lut[need] = np.arange(need.size)
        needs.append(need)
        k = chip_cols.astype(np.int64)
        return np.where(mxu_entry, lut[pan],
                        lut[pan] * bk + k % bk).astype(np.int32)

    # the chip axis keeps PER-MEMBER DMA windows (hot-shard fix): each
    # chip's staged ring is sized from ITS OWN largest block, so one hot
    # shard no longer tail-pads every chip to the cross-chip max
    st = stack_fused_workspaces(
        shards, member_nnz=[int(p.nnz) for p in plans], nnz_bases=bases,
        global_nnz=nnz, merge_width=merge_width, row_block=row_block,
        cols_map=_xshard_cols_map if x_sharding == "rows" else None)
    inv_perm = np.zeros(m, np.int32)
    for c, ws in enumerate(shards):
        r0, r1 = int(bounds[c]), int(bounds[c + 1])
        inv_perm[r0:r1] = c * st.ws_rows + ws.inv_perm

    x_fetch = x_send = x_recv = None
    own_panels = 0
    if x_sharding == "rows":
        own_panels = -(-x_panels // n_chips)
        x_fetch, x_send, x_recv = _x_fetch_tables(needs, own_panels,
                                                  n_chips)

    return ShardedFusedWorkspace(
        blk_off=st.blk_off, blk_L=st.blk_L, cols_flat=st.cols_flat,
        gather_flat=st.gather_flat, inv_perm=inv_perm, bounds=bounds,
        ws_rows=st.ws_rows, row_block=row_block, n_chips=n_chips,
        shard_plans=plans, blk_tag=st.blk_tag, blk_coff=st.blk_coff,
        bk=bk,
        max_span=int(st.member_span.max(initial=0)),
        max_cspan=int(st.member_cspan.max(initial=0)),
        chip_span=st.member_span, chip_cspan=st.member_cspan,
        x_sharding=x_sharding, x_panels=x_panels,
        x_own_panels=own_panels, x_fetch=x_fetch, x_send=x_send,
        x_recv=x_recv, merge_width=merge_width,
        pack_seconds=sum(ws.pack_seconds for ws in shards))


def _x_fetch_tables(needs: List[np.ndarray], own_panels: int,
                    n_chips: int):
    """Rectangular fetch/send/recv tables for the exact-panel exchange.

    ``needs[c]`` is chip ``c``'s sorted touched-panel set (0 always
    included, so table padding — which reuses panel 0 — never invents a
    panel nobody owns).  Panel ``p`` is owned by chip ``p //
    own_panels``; ``rank`` is ``p``'s position among the panels chip
    ``j`` needs from that owner, which is exactly its slot in the
    owner's send row — so the flat receive index is ``owner * T2 +
    rank`` whatever the mesh size.
    """
    T = max(need.size for need in needs)
    send_lists = [[[] for _ in range(n_chips)] for _ in range(n_chips)]
    recv_pairs = []
    for j, need in enumerate(needs):
        counts: dict = {}
        pairs = []
        for p in need.tolist():
            src = p // own_panels
            rank = counts.get(src, 0)
            counts[src] = rank + 1
            send_lists[src][j].append(p - src * own_panels)
            pairs.append((src, rank))
        recv_pairs.append(pairs)
    T2 = max((len(send_lists[s][j]) for s in range(n_chips)
              for j in range(n_chips)), default=0)
    T2 = max(T2, 1)
    x_fetch = np.zeros((n_chips, T), np.int32)
    x_send = np.zeros((n_chips, n_chips, T2), np.int32)
    x_recv = np.zeros((n_chips, T), np.int32)
    for j, need in enumerate(needs):
        x_fetch[j, :need.size] = need
        for t, (src, rank) in enumerate(recv_pairs[j]):
            x_recv[j, t] = src * T2 + rank
        # padding entries (t >= need.size) stay 0 == panel 0's slot
    for s in range(n_chips):
        for j in range(n_chips):
            row = send_lists[s][j]
            x_send[s, j, :len(row)] = row
    return x_fetch, x_send, x_recv


@dataclasses.dataclass
class BatchedFusedWorkspace:
    """Request-axis stacking for the multi-tenant serving tier
    (DESIGN.md §12): R small instances' descriptor tables stacked with
    :func:`stack_fused_workspaces` — the same rectangular trick the
    chip axis uses — then FLATTENED block-diagonally so the whole
    batch is ONE fused dispatch through the ordinary single-chip
    kernels.

    Flattening re-bases each request's member-relative offsets by its
    row in the stack (slot offsets by ``r*S``, column offsets by
    ``r*Sc``), its column entries into the stacked X operand (VPU rows
    by ``r * x_rows_pad``, MXU block-columns by ``r * x_rows_pad //
    bk``), and its gather entries into the concatenated global vals
    buffer.  Unlike the chip axis, one dispatch has ONE static DMA
    window, so the stack uses uniform windows (cross-request max) —
    every member offset plus the window then stays inside the member's
    own ``[r*S, (r+1)*S)`` region and a staged copy never crosses a
    request boundary.
    """
    blk_off: np.ndarray      # (R*B,) int32 — request base folded in
    blk_L: np.ndarray        # (R*B,) int32 — pad blocks: L == 0
    blk_tag: np.ndarray      # (R*B,) int32
    blk_coff: np.ndarray     # (R*B,) int32 — request base folded in
    cols_flat: np.ndarray    # (R*Sc,) int32 — into the stacked X rows
    gather_flat: np.ndarray  # (R*S,) int64 — into concat(all vals,[0])
    inv_perm: np.ndarray     # (sum m_r,) int32 into flattened ws rows
    row_splits: np.ndarray   # (R+1,) int64 — per-request output ranges
    val_splits: np.ndarray   # (R+1,) int64 — per-request vals ranges
    request_plans: List      # per-request plan (stats / nnz / seconds)
    n_requests: int
    num_blocks: int          # R * B
    ws_rows: int             # total workspace rows == num_blocks * bm
    row_block: int
    bk: int
    x_rows_pad: int          # per-request stacked-X row strip (bk mult)
    max_span: int            # uniform staged-DMA slot window
    max_cspan: int           # uniform staged-DMA cols window
    merge_width: int         # common CGCM width across the batch
    pack_seconds: float = 0.0

    @property
    def nnz(self) -> int:
        return int(self.val_splits[-1])

    @property
    def num_trips(self) -> int:
        return self.num_blocks // max(self.merge_width, 1)


def build_batched_workspace(structures, d: int, *,
                            strategy: str = "nnz_split",
                            row_block: int = 8,
                            backend: str = "pallas_ell", bk: int = 8,
                            mxu_gain: float = 4.0,
                            merge_threshold: int = 0,
                            fingerprint: str = "", max_dt: int = 512,
                            merge_target_segments: int = 16
                            ) -> BatchedFusedWorkspace:
    """Plan + pack R request structures ``(row_ptr, col_indices,
    shape)`` into one :class:`BatchedFusedWorkspace` (DESIGN.md §12).

    Each request runs the ordinary single-chip plan pipeline (build →
    merge → tag → pack) with the SAME knobs a solo dispatch would use,
    so the batched output is bit-identical to dispatching each request
    alone; only the CGCM width is coerced to a common value (the
    minimum of the members' own choices — the kernel takes one static
    width, and CGCM is bit-identical at any width).

    ``merge_threshold`` may be a single int (every member, the solo
    semantics) or a sequence of R per-member ints — the batched
    AUTOTUNED path (DESIGN.md §14.3) feeds each member its own tuned
    threshold, and the min-coercion of the resulting widths keeps the
    kernel's one static width.
    """
    if not structures:
        raise ValueError("build_batched_workspace needs >= 1 request")
    mixed = backend == "pallas_bcsr"
    structures = [(np.asarray(rp), np.asarray(ci), tuple(shape))
                  for rp, ci, shape in structures]
    if np.ndim(merge_threshold) == 0:
        merge_thresholds = [int(merge_threshold)] * len(structures)
    else:
        merge_thresholds = [int(t) for t in merge_threshold]
        if len(merge_thresholds) != len(structures):
            raise ValueError(
                f"per-member merge_threshold needs one entry per "
                f"request: got {len(merge_thresholds)} for "
                f"{len(structures)} structures")
    mw = min(choose_merge_width(rp, row_block=row_block,
                                merge_threshold=t)
             for (rp, _, _), t in zip(structures, merge_thresholds))
    plans: List = []
    shards: List[FusedEllWorkspace] = []
    bases: List[int] = []
    total_nnz = 0
    n_max = 0
    for r, (row_ptr, col_indices, shape) in enumerate(structures):
        if mixed:
            plan = build_mixed_plan(
                row_ptr, col_indices, shape, d, strategy=strategy,
                row_block=row_block, bk=bk, mxu_gain=mxu_gain,
                fingerprint=f"{fingerprint}/req{r}", max_dt=max_dt,
                merge_target_segments=merge_target_segments)
        else:
            plan = build_plan(row_ptr, col_indices, shape, d,
                              strategy=strategy, row_block=row_block,
                              fingerprint=f"{fingerprint}/req{r}",
                              max_dt=max_dt,
                              merge_target_segments=merge_target_segments)
        plans.append(plan)
        shards.append(build_fused_workspace(plan, merge_width=mw))
        bases.append(total_nnz)
        total_nnz += int(plan.nnz)
        n_max = max(n_max, int(shape[1]))
    # common bk-aligned X strip: request r's operand rows live at
    # [r * x_rows_pad, r * x_rows_pad + n_r) of the stacked X (the
    # mixed kernel slices whole bk-row panels, so the strip aligns)
    x_rows_pad = max(-(-n_max // bk), 1) * bk
    x_blocks = x_rows_pad // bk

    def _request_cols_map(r, ws, cols):
        # re-base into the stacked X: a VPU slot names a row, an MXU
        # entry a block-column (sentinel 0 shifts to the request's own
        # strip — still inert, its value is the 0.0 gather sentinel)
        _, mxu_entry = _chip_x_panels(ws, cols.shape[0], bk)
        k = cols.astype(np.int64)
        return np.where(mxu_entry, k + r * x_blocks,
                        k + r * x_rows_pad).astype(np.int32)

    st = stack_fused_workspaces(
        shards, member_nnz=[int(p.nnz) for p in plans], nnz_bases=bases,
        global_nnz=total_nnz, merge_width=mw, row_block=row_block,
        cols_map=_request_cols_map, uniform_windows=True)
    R, B = st.blk_L.shape
    S = int(st.gather_flat.shape[1])
    Sc = int(st.cols_flat.shape[1])
    assert R * max(S, Sc) < 2 ** 31, "batched streams overflow int32"
    # block-diagonal flatten: offsets are member-relative, so folding
    # request r's base in is one addition — the same re-basing trick
    # the chip gather uses for vals
    rbase = np.arange(R, dtype=np.int64)[:, None]
    blk_off = (st.blk_off.astype(np.int64) + rbase * S)
    blk_coff = (st.blk_coff.astype(np.int64) + rbase * Sc)
    row_splits = np.zeros(R + 1, np.int64)
    val_splits = np.zeros(R + 1, np.int64)
    for r, (_, _, shape) in enumerate(structures):
        row_splits[r + 1] = row_splits[r] + int(shape[0])
        val_splits[r + 1] = val_splits[r] + int(plans[r].nnz)
    inv_perm = np.zeros(int(row_splits[-1]), np.int32)
    for r, ws in enumerate(shards):
        inv_perm[row_splits[r]:row_splits[r + 1]] = (r * st.ws_rows
                                                     + ws.inv_perm)
    return BatchedFusedWorkspace(
        blk_off=blk_off.reshape(-1).astype(np.int32),
        blk_L=st.blk_L.reshape(-1),
        blk_tag=st.blk_tag.reshape(-1),
        blk_coff=blk_coff.reshape(-1).astype(np.int32),
        cols_flat=st.cols_flat.reshape(-1),
        gather_flat=st.gather_flat.reshape(-1),
        inv_perm=inv_perm, row_splits=row_splits, val_splits=val_splits,
        request_plans=plans, n_requests=R, num_blocks=R * B,
        ws_rows=R * st.ws_rows, row_block=row_block, bk=bk,
        x_rows_pad=x_rows_pad,
        max_span=int(st.member_span.max(initial=0)),
        max_cspan=int(st.member_cspan.max(initial=0)),
        merge_width=mw,
        pack_seconds=sum(ws.pack_seconds for ws in shards))
