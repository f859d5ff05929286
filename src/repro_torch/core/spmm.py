"""Public JIT-SpMM API: Y = A·X specialized to the runtime instance
(port of ``src/repro/core/spmm.py``).

``compile_spmm`` is the paper's "JIT code generator": given the concrete
structure of A and the runtime-known d, it plans on the host, checks the
workspace, moves the descriptor tables to the device once, and caches
the resulting ``CompiledSpmm`` under everything the specialization
depends on.  ``spmm`` is the one-shot convenience wrapper.

Backends (the reference's names, so tests compare like with like):
  pallas_ell   the whole multi-segment ELL plan is ONE launch — K1
               (``kernels/csrc/spmm_ell_fused.cu``) resident, K3
               (``spmm_ell_fused_staged.cu``) staged — plus one
               inverse-permutation gather.
  pallas_bcsr  the MIXED plan — each bm-aligned row-block tagged VPU
               (gather+FMA) or MXU ((bm x bk) block products) — is still
               ONE launch, of K2 (``spmm_bcsr_fused.cu``) or K4
               (``spmm_bcsr_fused_staged.cu``).
  ref          plain torch gather + ``index_add_``.
  dense        densified matmul (tiny tests only).

``backend="auto"`` resolves to ``pallas_bcsr`` on the card and ``ref`` on
the CPU, as the reference picks ``pallas_bcsr`` on a TPU; ``staging``
``"auto"`` resolves to ``"dma"`` (K3/K4) on the card and ``"resident"``
on the CPU, as the reference picks ``"dma"`` on a TPU.  ``device`` takes
the place of the reference's ``interpret`` knob: resolved once (``None``
= the CUDA card, raising when there is none), it joins every cache key.
On the CPU the fused backends run the kernels' plain versions.

Gradients: calling an artifact is a ``torch.autograd.Function`` (the
reference's ``custom_vjp``).  dX = Aᵀ·dY runs through a transposed
artifact cached beside the forward one, on the same fused kernel and
staging mode; dvals is the SDDMM ``sum(dY[rows] * X[cols], -1)`` in
plain torch, as the reference computes it outside any kernel.

``compile_sparse_attention`` / ``sparse_attention`` run the fused
sparse-attention sandwich ``softmax(mask ⊙ Q·Kᵀ)·V`` through the same
plan, in ONE launch of K5 (``kernels/csrc/attn_fused.cu``) or, staged,
K6 (``attn_fused_staged.cu``, the card's default).  Its backward
differentiates the plain-torch reference formulation, recomputed in
chunks of whole query rows, as the reference's ``jax.vjp`` of its jnp
oracle does.

Sharding (``mesh``/``n_chips``, fused backends only): the rows are
partitioned over the chips of a ``ChipMesh`` (``build_sharded_workspace``)
and each chip runs its range as ONE launch of the same kernels on its
own device (K8, ``kernels/*_sharded``); the chips' workspaces are
concatenated on the caller's device and one GLOBAL ``inv_perm`` gather
restores row order.  ``x_sharding="rows"`` splits X into bk-row panels
owned by the chips and runs the exact-panel exchange before the
launches (``distributed/collectives.py``); ``"auto"`` resolves to
``"rows"`` on a mesh that spans more than one device and
``"replicated"`` where the chips share one (the CPU's chips, or one
card's), where owning X panels saves no memory.  A mesh may repeat a device (``ChipMesh(("cuda:0",) * 4)``),
and the sharded output equals the unsharded one bit for bit.  Sparse
attention shards the same way with K/V replicated.

``compile_spmm(..., autotune=True)`` searches the plan knobs per
instance (``core/autotune.py``).  ``compile_batched_spmm`` stacks R
tenants' structures into ONE fused launch for the serving tier
(``launch/serve.py``), bit for bit each tenant's solo forward.

An artifact holds its ``JitCache`` through a weak reference (it needs it
only to cache its transposed artifact), so an artifact the cache drops —
cleared or evicted — frees its device tables as soon as the caller lets
go of it, without waiting for the cyclic garbage collector.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Optional

import numpy as np
import torch

from . import ccm
from .csr import CSRMatrix
from .jit_cache import GLOBAL_CACHE, JitCache, mesh_fingerprint
from .plan import (SPARSE_ATTN_EINSUM, SPARSE_ATTN_MIXED_EINSUM,
                   BatchedFusedWorkspace, MixedPlan, ShardedFusedWorkspace,
                   SpmmPlan, build_batched_workspace, build_einsum_workspace,
                   build_fused_workspace, build_mixed_plan, build_plan,
                   build_sharded_workspace, choose_merge_width,
                   sharded_workspace_row_maps, workspace_row_map)
from ..analysis.verify import PlanVerificationError, check_workspace
from ..distributed.sharding import (ChipMesh, aligned16, chip_mesh,
                                    place_on_chips, resolve_chip_mesh)
from ..kernels.ops import (attn_fused_op, attn_fused_sharded_op,
                           record_build_seconds, resolve_device,
                           resolve_staging, resolve_validate,
                           spmm_bcsr_fused_op, spmm_bcsr_fused_sharded_op,
                           spmm_ell_fused_op, spmm_ell_fused_sharded_op)
from ..kernels.ref import spmm_coo_ref, spmm_dense_ref
from ..kernels.sddmm import sddmm

__all__ = ["BACKENDS", "FUSED_BACKENDS", "X_SHARDING_MODES", "ChipMesh",
           "CompiledBatchedSpmm", "CompiledSparseAttention", "CompiledSpmm",
           "PlanVerificationError", "chip_mesh", "compile_batched_spmm",
           "compile_sparse_attention", "compile_spmm", "resolve_chip_mesh",
           "sparse_attention", "spmm"]

# bound on the (nonzeros x d) products one SDDMM chunk holds at a time:
# 2^28 float32 entries, 1 GiB for each of dY[rows] and X[cols]; the
# attention backward's chunks of whole query rows, over every instance
# of a call, keep to it as well.  Each such chunk costs the host ~45
# dispatches, and the one host thread enqueues every card's: a longformer
# layer's 8 instances a model chip (2.19 M nonzeros each at S = 4096)
# take 9 chunks
SDDMM_CHUNK = 1 << 28
# the fused backends' dvals run K7 over pairs padded to a multiple of
# this many, its default pair group
SDDMM_T = 128

BACKENDS = ("pallas_ell", "pallas_bcsr", "ref", "dense", "auto")

# backends that lower through the fused descriptor-table launch (and
# therefore take the staging knob)
FUSED_BACKENDS = ("pallas_ell", "pallas_bcsr")

# X placement on the sharded fused path (DESIGN.md §7.8):
#   replicated  every chip holds all of X
#   rows        X rows are split into bk-row panels owned contiguously by
#               the chips; each chip fetches exactly the panels its
#               descriptor stream touches (the exact-panel exchange)
X_SHARDING_MODES = ("replicated", "rows")


def _resolve_x_sharding_for(backend: str, x_sharding, mesh) -> str:
    """The effective X placement, resolved ONCE like staging:
    ``None``/``"auto"`` picks ``"rows"`` on a mesh that spans more than
    one device, where each chip then holds only the X panels it reads,
    and ``"replicated"`` unsharded or where the chips share one device
    (the CPU's chips, the reference's interpret mode; or one card's),
    where rows would add the exchange and save no memory; the resolved string joins every cache key that
    touches it, the transposed artifact's included.  ``"rows"`` without
    a mesh, or anything but replicated on a non-fused backend, raises."""
    if backend in FUSED_BACKENDS:
        if x_sharding in (None, "auto"):
            if mesh is not None and not mesh.single_device:
                return "rows"
            return "replicated"
        if x_sharding not in X_SHARDING_MODES:
            raise ValueError(
                f"x_sharding must be 'auto' or one of {X_SHARDING_MODES}, "
                f"got {x_sharding!r}")
        if x_sharding == "rows" and mesh is None:
            raise ValueError(
                "x_sharding='rows' shards X over the chip mesh — pass mesh= "
                "or n_chips= (unsharded dispatch has no chips to own X "
                "panels)")
        return x_sharding
    if x_sharding not in (None, "auto", "replicated"):
        raise ValueError(
            f"x_sharding is a fused-dispatch knob "
            f"({'/'.join(FUSED_BACKENDS)}); backend={backend!r} has no "
            f"sharded lowering")
    return "replicated"


def _resolve_backend(backend: str, device: str, *,
                     sharded: bool = False) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend != "auto":
        return backend
    if device != "cpu":
        # the mixed fused path on the card: MXU trips where block
        # structure pays, VPU trips elsewhere, sharded or not
        return "pallas_bcsr"
    # a sharding request must land on a fused backend on the CPU too
    # (the reference's interpret-mode choice); else the plain oracle
    return "pallas_ell" if sharded else "ref"


def _resolve_mesh_for(backend: str, mesh, n_chips, device: str):
    """The artifact's chip mesh (None = unsharded): ``n_chips`` alone
    builds one on ``device``'s type; a mesh of another device type than
    ``device``, or any mesh on a non-fused backend, raises."""
    mesh = resolve_chip_mesh(mesh, n_chips, device)
    if mesh is None:
        return None
    if mesh.device_type != torch.device(device).type:
        raise ValueError(f"the mesh's chips are on {mesh.device_type}, the "
                         f"artifact's device is {device}")
    if backend not in FUSED_BACKENDS:
        raise ValueError(
            f"mesh/n_chips sharding is a fused-dispatch feature "
            f"({'/'.join(FUSED_BACKENDS)}); backend={backend!r} is "
            f"single-device")
    return mesh


def _resolve_staging_for(backend: str, staging, device: str) -> str:
    """Per-backend staging resolution: the knob only exists on the fused
    launch, so non-fused backends pin ``"resident"`` and reject an
    explicit ``"dma"`` — keeping ref/dense cache keys independent of a
    knob they ignore."""
    if backend in FUSED_BACKENDS:
        return resolve_staging(staging, device)
    if staging not in (None, "auto", "resident"):
        raise ValueError(
            f"staging is a fused-dispatch knob ({'/'.join(FUSED_BACKENDS)});"
            f" backend={backend!r} has no staged lowering")
    return "resident"


def _verify_workspace_timed(ws, *, level: str, context: str,
                            **kwargs) -> None:
    """Run the static verifier (DESIGN.md §15) over a freshly packed
    workspace BEFORE any device constants are built, raising
    :class:`PlanVerificationError` on a malformed plan; the host cost
    lands in ``BUILD_SECONDS["verify"]``."""
    if level == "off":
        return
    t0 = time.perf_counter()
    try:
        check_workspace(ws, level=level, context=context, **kwargs)
    finally:
        record_build_seconds("verify", time.perf_counter() - t0)


@dataclasses.dataclass
class _FusedConsts:
    """Device-resident fused-plan constants: ONE descriptor table + flat
    slot arrays for all segments, so the forward pass is a single launch
    plus one inverse-permutation gather."""
    blk_tag: torch.Tensor      # (B,) int32 — VPU/MXU tag
    blk_off: torch.Tensor      # (B,) int32 — first slot per row-block
    blk_coff: torch.Tensor     # (B,) int32 — first entry in cols_flat
    blk_L: torch.Tensor        # (B,) int32 — loop trips per row-block
    cols_flat: torch.Tensor    # (Sc,) int32 — X row / block-column stream
    gather_flat: torch.Tensor  # (S,) int64 — slot -> concat(vals,[0]) index
    inv_perm: torch.Tensor     # (m,) int64 — output row -> workspace row
    num_blocks: int
    merge_width: int = 1       # CGCM width (DESIGN.md §7.9)
    max_span: int = 0          # staged window over the slot stream
    max_cspan: int = 0         # staged window over the column stream


@dataclasses.dataclass
class _ShardedConsts:
    """Multi-chip fused constants: per-chip descriptor tables, each on its
    chip's device, the GLOBAL inverse permutation into the flattened
    (C * ws_rows) workspace on the caller's device, the per-chip staged
    windows and, under ``x_sharding="rows"``, the exchange tables."""
    blk_tag: tuple             # C x (B,) int32
    blk_off: tuple             # C x (B,) int32
    blk_coff: tuple            # C x (B,) int32
    blk_L: tuple               # C x (B,) int32 (0 == pad descriptor)
    cols_flat: tuple           # C x (Sc,) int32
    gather_flat: tuple         # C x (S,) int64 -> GLOBAL concat(vals,[0])
    inv_perm: torch.Tensor     # (m,) int64 into the flattened workspace
    ws_rows: int               # per-chip workspace rows
    num_blocks: int            # common per-chip block count B
    mesh: ChipMesh
    merge_width: int = 1
    chip_span: tuple = ()      # per-chip staged slot windows
    chip_cspan: tuple = ()     # per-chip staged column windows
    x_sharding: str = "replicated"
    x_panels: int = 0
    x_own_panels: int = 0
    x_send: Optional[tuple] = None   # C x (C, T2) own-local panel ids
    x_recv: Optional[tuple] = None   # C x (T,) into the (C*T2,) buffer

    @classmethod
    def build(cls, sw: ShardedFusedWorkspace, mesh: ChipMesh, device: str):
        def chips(arr, dtype=torch.int32):
            return place_on_chips(torch.from_numpy(
                np.ascontiguousarray(arr)).to(dtype), mesh)

        rows = sw.x_sharding == "rows"
        return cls(
            blk_tag=chips(sw.blk_tag), blk_off=chips(sw.blk_off),
            blk_coff=chips(sw.blk_coff), blk_L=chips(sw.blk_L),
            cols_flat=chips(sw.cols_flat),
            gather_flat=chips(sw.gather_flat, torch.int64),
            inv_perm=torch.from_numpy(sw.inv_perm.astype(np.int64)).to(
                device),
            ws_rows=sw.ws_rows, num_blocks=sw.num_blocks, mesh=mesh,
            merge_width=sw.merge_width,
            chip_span=tuple(int(s) for s in sw.chip_span),
            chip_cspan=tuple(int(s) for s in sw.chip_cspan),
            x_sharding=sw.x_sharding, x_panels=sw.x_panels,
            x_own_panels=sw.x_own_panels,
            x_send=chips(sw.x_send, torch.int64) if rows else None,
            x_recv=chips(sw.x_recv, torch.int64) if rows else None)

    def chip_vals(self, vals_ext: torch.Tensor) -> tuple:
        """Each chip's slot values, gathered on its own device."""
        return tuple(vals_ext.to(dev)[g]
                     for dev, g in zip(self.mesh.devices, self.gather_flat))

    def gather_rows(self, y_ws: torch.Tensor, width: int, device: str):
        """Output row order from the chips' (C, B*bm, d_pad) workspaces:
        flattened on the caller's device, then the GLOBAL ``inv_perm``."""
        y_flat = y_ws.to(device).reshape(-1, y_ws.shape[-1])
        return y_flat[self.inv_perm, :width]


class _Apply(torch.autograd.Function):
    """The artifact's forward with the reference's custom VJP: dvals by
    SDDMM, dX through the transposed artifact; a gradient nobody asked
    for is not computed."""

    @staticmethod
    def forward(ctx, c: "CompiledSpmm", vals, x):
        ctx.c = c
        ctx.save_for_backward(vals, x)
        return c._forward(vals, x)

    @staticmethod
    def backward(ctx, dy):
        vals, x = ctx.saved_tensors
        c = ctx.c
        dvals = dx = None
        if ctx.needs_input_grad[1]:
            dvals = c._sddmm(dy, x).to(vals.dtype)
        if ctx.needs_input_grad[2]:
            dx = c._transpose_apply(vals, dy).to(x.dtype)
        return None, dvals, dx


class CompiledSpmm:
    """The "jit-function": structure-specialized, value-generic SpMM,
    differentiable in ``vals`` and ``x``, on one device or sharded over
    a chip mesh.  On the fused backends the host workspace it was packed
    from stays readable as ``workspace`` (``sharded_workspace`` when
    sharded)."""

    def __init__(self, a: CSRMatrix, d: int, *, strategy: str,
                 backend: str, device: Optional[str] = None, bm: int = 8,
                 bk: int = 8, mxu_gain: float = 4.0,
                 staging: Optional[str] = None, merge_threshold: int = 0,
                 validate: Optional[str] = None,
                 mesh: Optional[ChipMesh] = None,
                 n_chips: Optional[int] = None,
                 x_sharding: Optional[str] = None,
                 cache: JitCache = GLOBAL_CACHE):
        # resolved ONCE: the effective device is part of the compiled
        # artifact's identity (and of every jit-cache key touching it)
        self.device = resolve_device(device)
        self.backend = _resolve_backend(
            backend, self.device,
            sharded=mesh is not None or n_chips is not None)
        self.mesh = _resolve_mesh_for(self.backend, mesh, n_chips,
                                      self.device)
        self.n_chips = None if self.mesh is None else self.mesh.size
        self.x_sharding = _resolve_x_sharding_for(self.backend, x_sharding,
                                                  self.mesh)
        self.strategy = strategy
        self.bm = bm
        self.bk = bk
        self.mxu_gain = mxu_gain
        self.merge_threshold = int(merge_threshold)
        self.validate = resolve_validate(validate, self.device)
        self.staging = _resolve_staging_for(self.backend, staging,
                                            self.device)
        self.d = d
        self.shape = a.shape
        # weak: the cache holds this artifact, and a strong reference
        # back would keep a cleared or evicted artifact's device tables
        # alive until the cyclic garbage collector runs
        self._cache_ref = weakref.ref(cache)
        # the structure, for the backward's transposed artifact and SDDMM
        self._fingerprint = a.fingerprint
        self._row_ptr = a.row_ptr
        self._col_indices = a.col_indices
        self._transpose: Optional[CompiledSpmm] = None
        self._t_order: Optional[torch.Tensor] = None
        self._rows: Optional[torch.Tensor] = None
        self._cols: Optional[torch.Tensor] = None
        self._pairs: Optional[tuple] = None
        # the mixed kernel slices (bk, d_pad) X panels per block-column,
        # so X rows are padded up to the block-column grid
        self._x_rows_pad = -(-a.shape[1] // bk) * bk

        def dev(arr: np.ndarray, dtype=torch.int32) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=dtype)

        self.plan: Optional[SpmmPlan] = None
        self.mixed_plan: Optional[MixedPlan] = None
        self._fused: Optional[_FusedConsts] = None
        self._sharded: Optional[_ShardedConsts] = None
        if self.mesh is not None:
            # the sharded workspace re-plans every chip's rows itself;
            # only the d tiling is needed at this level
            self.d_tiling = ccm.plan_d_tiles(d, rows_in_flight=bm)
            sw = build_sharded_workspace(
                a.row_ptr, a.col_indices, a.shape, d, n_chips=self.n_chips,
                strategy=strategy, row_block=bm, fingerprint=a.fingerprint,
                backend=self.backend, bk=bk, mxu_gain=mxu_gain,
                x_sharding=self.x_sharding,
                merge_threshold=self.merge_threshold)
            _verify_workspace_timed(
                sw, level=self.validate, n_cols=a.shape[1],
                context=f"compile_spmm[{self.backend}/sharded]")
            self.sharded_workspace = sw
            self._sharded = _ShardedConsts.build(sw, self.mesh, self.device)
            record_build_seconds(
                "plan", sum(p.plan_seconds for p in sw.shard_plans))
            record_build_seconds("pack", sw.pack_seconds)
        elif self.backend == "pallas_bcsr":
            self.mixed_plan = build_mixed_plan(
                a.row_ptr, a.col_indices, a.shape, d, strategy=strategy,
                row_block=bm, bk=bk, mxu_gain=mxu_gain,
                fingerprint=a.fingerprint)
            self.d_tiling = self.mixed_plan.d_tiling
        elif self.backend == "pallas_ell":
            self.plan = build_plan(
                a.row_ptr, a.col_indices, a.shape, d, strategy=strategy,
                row_block=bm, fingerprint=a.fingerprint)
            self.d_tiling = self.plan.d_tiling

        if self.backend in FUSED_BACKENDS and self.mesh is None:
            # merge stage: the CGCM width is a plan-time decision from
            # the instance's row lengths (DESIGN.md §7.9); 1 = no merge
            mw = choose_merge_width(a.row_ptr, row_block=bm,
                                    merge_threshold=self.merge_threshold)
            plan = self.mixed_plan or self.plan
            ws = build_fused_workspace(plan, merge_width=mw)
            _verify_workspace_timed(
                ws, level=self.validate, n_cols=a.shape[1],
                context=f"compile_spmm[{self.backend}]")
            self.workspace = ws
            self._fused = _FusedConsts(
                blk_tag=dev(ws.blk_tag), blk_off=dev(ws.blk_off),
                blk_coff=dev(ws.blk_coff), blk_L=dev(ws.blk_L),
                cols_flat=dev(ws.cols_flat),
                gather_flat=dev(ws.gather_flat, torch.int64),
                inv_perm=dev(ws.inv_perm, torch.int64),
                num_blocks=ws.num_blocks, merge_width=ws.merge_width,
                max_span=ws.max_span, max_cspan=ws.max_cspan)
            record_build_seconds("plan", plan.plan_seconds)
            record_build_seconds("pack", ws.pack_seconds)
        elif self.backend not in FUSED_BACKENDS:
            # the row expansion is pure structure — precompute it so the
            # serving path never repeats the host-side np.repeat
            self._expanded()

    def _expanded(self):
        """(nnz,) int64 row and column of every nonzero on the device —
        shared by the ref/dense forwards and their SDDMM gradient (built
        once, at compile time)."""
        if self._rows is None:
            m = self.shape[0]
            self._rows = torch.from_numpy(
                np.repeat(np.arange(m), np.diff(self._row_ptr))).to(
                    self.device)
            self._cols = torch.from_numpy(
                self._col_indices.astype(np.int64)).to(self.device)
        return self._rows, self._cols

    # -- forward -----------------------------------------------------------
    def _check_operands(self, vals: torch.Tensor, x: torch.Tensor) -> None:
        if x.dim() != 2 or x.shape[1] != self.d:
            raise ValueError(f"x must be (n, {self.d}), got "
                             f"{tuple(x.shape)}")
        for name, t in (("vals", vals), ("x", x)):
            if torch.device(self.device) != t.device:
                raise ValueError(f"{name} is on {t.device}, but this "
                                 f"artifact was compiled for {self.device}")

    def _forward(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        self._check_operands(vals, x)
        m, n = self.shape
        d = x.shape[1]
        backend = self.backend
        if backend == "dense":
            dense = torch.zeros((m, n), dtype=vals.dtype, device=x.device)
            dense[self._rows, self._cols] = vals
            return spmm_dense_ref(dense, x)
        if backend == "ref":
            return spmm_coo_ref(self._rows, self._cols, vals, x, m)
        if self._sharded is not None:
            sw = self._sharded
            if sw.num_blocks == 0:
                return torch.zeros((m, d), dtype=torch.float32,
                                   device=x.device)
            # one launch PER CHIP, each on its own descriptor shard
            operands, knobs = self.sharded_operands(vals, x)
            op = (spmm_ell_fused_sharded_op if backend == "pallas_ell"
                  else spmm_bcsr_fused_sharded_op)
            y_ws = op(*operands, **knobs, staging=self.staging,
                      span=sw.chip_span, cspan=sw.chip_cspan)
            return sw.gather_rows(y_ws, d, self.device)
        fw = self._fused
        if fw.num_blocks == 0:
            return torch.zeros((m, d), dtype=torch.float32, device=x.device)
        operands, knobs = self.fused_operands(vals, x)
        op = (spmm_ell_fused_op if backend == "pallas_ell"
              else spmm_bcsr_fused_op)
        y_ws = op(*operands, **knobs, staging=self.staging,
                  span=fw.max_span, cspan=fw.max_cspan)
        # single inverse-permutation gather restores row order
        return y_ws[fw.inv_perm, :d]

    def _padded_x(self, x: torch.Tensor) -> torch.Tensor:
        """X padded to the lane tile and, on ``pallas_bcsr``, to whole
        block-columns of rows."""
        x_pad = ccm.pad_cols(x.float(), self.d_tiling.d_pad)
        if self.backend == "pallas_bcsr" and x_pad.shape[0] < \
                self._x_rows_pad:
            x_pad = torch.nn.functional.pad(
                x_pad, (0, 0, 0, self._x_rows_pad - x_pad.shape[0]))
        return aligned16(x_pad.contiguous())

    def fused_operands(self, vals: torch.Tensor, x: torch.Tensor):
        """The fused kernel's arguments for one forward: the descriptor
        tables, the gathered slot values and the padded X (positional,
        in the kernel's order), and its static knobs.  Gathering the
        values is the forward's one pass over ``vals``."""
        fw = self._fused
        vals_ext = torch.cat([vals.float(),
                              vals.new_zeros(1, dtype=torch.float32)])
        vals_flat = vals_ext[fw.gather_flat]
        x_pad = self._padded_x(x)
        if self.backend == "pallas_ell":
            return ((fw.blk_off, fw.blk_L, fw.cols_flat, vals_flat, x_pad),
                    dict(bm=self.bm, mw=fw.merge_width))
        return ((fw.blk_tag, fw.blk_off, fw.blk_coff, fw.blk_L,
                 fw.cols_flat, vals_flat, x_pad),
                dict(bm=self.bm, bk=self.bk, mw=fw.merge_width))

    def sharded_operands(self, vals: torch.Tensor, x: torch.Tensor):
        """The sharded wrapper's arguments for one forward (the per-chip
        tables, each chip's gathered slot values, and X — replicated, or
        as the stacked owned-panel strips under ``"rows"``) and its
        knobs: the mesh, the widths and the exchange tables."""
        sw = self._sharded
        vals_ext = torch.cat([vals.float(),
                              vals.new_zeros(1, dtype=torch.float32)])
        x_pad = self._padded_x(x)
        xarg = (self._x_row_strips(x_pad) if sw.x_sharding == "rows"
                else x_pad)
        knobs = dict(mesh=sw.mesh, bm=self.bm, mw=sw.merge_width,
                     x_sharding=sw.x_sharding, x_send=sw.x_send,
                     x_recv=sw.x_recv)
        vals_flat = sw.chip_vals(vals_ext)
        if self.backend == "pallas_ell":
            return (sw.blk_off, sw.blk_L, sw.cols_flat, vals_flat,
                    xarg), knobs
        return ((sw.blk_tag, sw.blk_off, sw.blk_coff, sw.blk_L,
                 sw.cols_flat, vals_flat, xarg), dict(knobs, bk=self.bk))

    def _x_row_strips(self, x_pad: torch.Tensor) -> torch.Tensor:
        """The dense operand as the (C, P, bk, d_pad) owned-panel strips
        the row-sharded dispatch takes: rows padded to whole bk-row
        panels, panels padded to a rectangular strip per chip; chip c's
        strip then goes to its device (``place_on_chips``)."""
        sw = self._sharded
        n_rows = sw.x_panels * self.bk
        if x_pad.shape[0] < n_rows:
            x_pad = torch.nn.functional.pad(
                x_pad, (0, 0, 0, n_rows - x_pad.shape[0]))
        strips = x_pad.reshape(sw.x_panels, self.bk, x_pad.shape[1])
        total = sw.mesh.size * sw.x_own_panels
        if sw.x_panels < total:
            strips = torch.nn.functional.pad(
                strips, (0, 0, 0, 0, 0, total - sw.x_panels))
        return strips.reshape(sw.mesh.size, sw.x_own_panels, self.bk,
                              x_pad.shape[1])

    # -- gradients ----------------------------------------------------------
    def _sddmm_pairs(self):
        """K7's pair operands: the (row, col) of every nonzero in CSR
        order, int32 on the device, padded with (0, 0) to a multiple of
        :data:`SDDMM_T`; built once, on the first backward that needs
        dvals."""
        if self._pairs is None:
            nnz = self._col_indices.shape[0]
            pairs = np.zeros((2, -(-nnz // SDDMM_T) * SDDMM_T), np.int32)
            pairs[0, :nnz] = np.repeat(np.arange(self.shape[0]),
                                       np.diff(self._row_ptr))
            pairs[1, :nnz] = self._col_indices
            self._pairs = tuple(torch.from_numpy(p).to(self.device)
                                for p in pairs)
        return self._pairs

    def _sddmm(self, dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """dvals[p] = sum_d dY[row_p, d] * X[col_p, d].  The fused
        backends run K7 (``kernels.sddmm``: the kernel on the card, its
        plain version on the CPU) over :meth:`_sddmm_pairs`.  ``ref`` and
        ``dense`` stay plain torch, as their forwards do, in chunks of
        nonzeros so the gathered rows stay within :data:`SDDMM_CHUNK`
        entries; each nonzero's sum is the same as unchunked."""
        if self.backend in FUSED_BACKENDS:
            nnz = self._col_indices.shape[0]
            if nnz == 0:
                return torch.zeros(0, dtype=torch.float32, device=dy.device)
            rows, cols = self._sddmm_pairs()
            return sddmm(rows, cols, aligned16(dy.float().contiguous()),
                         aligned16(x.float().contiguous()), T=SDDMM_T)[:nnz]
        rows, cols = self._expanded()
        out = torch.empty(rows.shape[0], dtype=torch.float32,
                          device=dy.device)
        step = max(1, SDDMM_CHUNK // max(dy.shape[1], 1))
        for s0 in range(0, rows.shape[0], step):
            r, c = rows[s0:s0 + step], cols[s0:s0 + step]
            out[s0:s0 + step] = (dy[r].float() * x[c].float()).sum(-1)
        return out

    def _transpose_apply(self, vals: torch.Tensor,
                         dy: torch.Tensor) -> torch.Tensor:
        """dX = Aᵀ·dY through the transposed artifact: built once, cached
        in this artifact's ``JitCache`` with every knob of the forward
        (the staging mode included), and fed ``vals[t_order]``.  When
        that cache is gone (an artifact compiled into a temporary
        ``JitCache()``), the transposed artifact is built for this one
        and held by it alone."""
        if self._transpose is None:
            a = CSRMatrix(self.shape, self._row_ptr, self._col_indices,
                          torch.zeros(self._col_indices.shape[0],
                                      device=self.device))
            t_struct, order = a.transpose_structure()
            key = ("spmmT", self._fingerprint, self.d, self.strategy,
                   self.backend, self.bm, self.bk, self.mxu_gain,
                   self.device, self.staging, self.x_sharding,
                   self.merge_threshold, self.validate,
                   mesh_fingerprint(self.mesh))
            cache = self._cache_ref()

            def build():
                return CompiledSpmm(
                    t_struct, self.d, strategy=self.strategy,
                    backend=self.backend, device=self.device, bm=self.bm,
                    bk=self.bk, mxu_gain=self.mxu_gain, staging=self.staging,
                    merge_threshold=self.merge_threshold,
                    validate=self.validate, mesh=self.mesh,
                    x_sharding=self.x_sharding,
                    cache=JitCache() if cache is None else cache)

            self._transpose = (build() if cache is None
                               else cache.get_or_build(key, build))
            self._t_order = torch.from_numpy(order).to(self.device)
        return self._transpose._forward(vals[self._t_order], dy)

    def __call__(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _Apply.apply(self, vals, x)


def compile_spmm(a: CSRMatrix, d: int, *, strategy: str = "nnz_split",
                 backend: str = "auto", device: Optional[str] = None,
                 bm: int = 8, bk: int = 8, mxu_gain: float = 4.0,
                 staging: Optional[str] = None, merge_threshold: int = 0,
                 validate: Optional[str] = None,
                 mesh: Optional[ChipMesh] = None,
                 n_chips: Optional[int] = None,
                 x_sharding: Optional[str] = None,
                 autotune: bool = False, measure=None, candidates=None,
                 top_k: int = 3, cache_priority: float = 0.0,
                 cache: JitCache = GLOBAL_CACHE) -> CompiledSpmm:
    """Build (or fetch) the structure-specialized SpMM artifact.

    ``device`` is resolved once (``None`` = the CUDA card; pass
    ``"cpu"`` to run the kernels' plain versions) and is part of the
    cache key, like every other knob here.  ``bk`` / ``mxu_gain``
    parameterize the pallas_bcsr mixed plan (block width, VPU-vs-MXU
    tagging).  ``staging`` selects the fused kernels' operand staging
    (DESIGN.md §7.7): ``"resident"`` runs K1/K2, ``"dma"`` the staged
    K3/K4; ``"auto"``/``None`` resolves to ``"dma"`` on the card and
    ``"resident"`` on the CPU.  ``merge_threshold`` drives
    the CGCM merge stage (DESIGN.md §7.9): 0 disables merging, a
    positive value lets up to ``MAX_MERGE_WIDTH`` short block-rows share
    one CTA; the output is identical either way.  ``validate`` runs the
    static plan verifier (DESIGN.md §15): ``"off"`` / ``"cheap"`` /
    ``"full"``, with ``"auto"``/``None`` resolving to ``"full"`` on the
    CPU and ``"off"`` on the card.

    ``mesh`` (a ``ChipMesh``) / ``n_chips`` (fused backends only) shard
    the plan's rows over the chips: each runs its range as one launch on
    its own device, and the output equals the unsharded one bit for
    bit.  ``n_chips`` alone takes the first ``n_chips`` cards (or CPU
    chips with ``device="cpu"``); a mesh may repeat a device.
    ``x_sharding`` places X: ``"replicated"`` on every chip, or
    ``"rows"``, owned by the chips in bk-row panels and fetched by the
    exact-panel exchange; ``"auto"``/``None`` is ``"rows"`` on a mesh
    that spans more than one device, else ``"replicated"``.  The resolved
    mesh and ``x_sharding`` join the cache key.

    ``autotune=True`` instead searches strategy × merge × staging per
    instance (``core.autotune``, memoized in the same cache): the
    explicit knobs then serve as the search's fallback, and ``measure``
    / ``candidates`` / ``top_k`` pass through to the search (tests inject
    a fake timer).  ``cache_priority`` is the artifact's SLA eviction
    score (DESIGN.md §14.4): the serving tier maps a tenant's deadline
    hint onto it, so a capacity-bounded cache sheds cold tenants'
    artifacts first."""
    if autotune:
        from .autotune import autotune_spmm
        return autotune_spmm(a, d, backend=backend, bm=bm, bk=bk,
                             mxu_gain=mxu_gain, device=device, mesh=mesh,
                             n_chips=n_chips, staging=staging,
                             x_sharding=x_sharding, validate=validate,
                             measure=measure, candidates=candidates,
                             top_k=top_k, cache_priority=cache_priority,
                             cache=cache)
    device = resolve_device(device)
    backend = _resolve_backend(
        backend, device, sharded=mesh is not None or n_chips is not None)
    staging = _resolve_staging_for(backend, staging, device)
    mesh = _resolve_mesh_for(backend, mesh, n_chips, device)
    x_sharding = _resolve_x_sharding_for(backend, x_sharding, mesh)
    merge_threshold = int(merge_threshold)
    validate = resolve_validate(validate, device)
    key = ("spmm", a.fingerprint, d, strategy, backend, bm, bk, mxu_gain,
           device, staging, x_sharding, merge_threshold, validate,
           mesh_fingerprint(mesh))
    return cache.get_or_build(
        key, lambda: CompiledSpmm(a, d, strategy=strategy, backend=backend,
                                  device=device, bm=bm, bk=bk,
                                  mxu_gain=mxu_gain, staging=staging,
                                  merge_threshold=merge_threshold,
                                  validate=validate, mesh=mesh,
                                  x_sharding=x_sharding, cache=cache),
        priority=cache_priority)


class CompiledBatchedSpmm:
    """Request-axis batched artifact for the serving tier (DESIGN.md
    §12; port of the reference's class of the same name): R
    structure-specialized instances stacked block-diagonally
    (:func:`build_batched_workspace`) into ONE fused launch of the
    ordinary single-device kernels — K1/K3 on ``pallas_ell``, K2/K4 on
    ``pallas_bcsr`` — and one ``inv_perm`` gather.

    Bit-identical to dispatching each request alone with the same knobs:
    slot padding, d-bucket padding, the uniform staged windows and the
    common CGCM width (the minimum of the members') all leave each
    lane's accumulation order untouched.  Forward-only: the endpoint
    never differentiates through a served batch.  It holds no reference
    to its cache.
    """

    def __init__(self, structures, d: int, *,
                 strategy: str = "nnz_split", backend: str = "auto",
                 device: Optional[str] = None, bm: int = 8, bk: int = 8,
                 mxu_gain: float = 4.0, staging: Optional[str] = None,
                 merge_threshold=0, validate: Optional[str] = None):
        self.device = resolve_device(device)
        # sharded=True resolution: batching stacks descriptor tables, so
        # "auto" must land on a fused backend on the CPU too
        self.backend = _resolve_backend(backend, self.device, sharded=True)
        if self.backend not in FUSED_BACKENDS:
            raise ValueError(
                f"batched dispatch stacks descriptor tables — a fused "
                f"backend is required ({'/'.join(FUSED_BACKENDS)}), "
                f"got {self.backend!r}")
        self.strategy = strategy
        self.bm = bm
        self.bk = bk
        self.mxu_gain = mxu_gain
        # scalar = one CGCM threshold for every member; a sequence
        # carries each member's own tuned threshold into the common-
        # width fold (DESIGN.md §14.3)
        self.merge_threshold = _normalize_batch_merge_threshold(
            merge_threshold, len(structures))
        self.validate = resolve_validate(validate, self.device)
        self.staging = _resolve_staging_for(self.backend, staging,
                                            self.device)
        self.d = int(d)
        self.shapes = [tuple(int(v) for v in a.shape) for a in structures]
        self.d_tiling = ccm.plan_d_tiles(d, rows_in_flight=bm)
        bw: BatchedFusedWorkspace = build_batched_workspace(
            [(a.row_ptr, a.col_indices, a.shape) for a in structures],
            d, strategy=strategy, row_block=bm, backend=self.backend,
            bk=bk, mxu_gain=mxu_gain,
            merge_threshold=self.merge_threshold,
            fingerprint="+".join(a.fingerprint[:8] for a in structures))
        self.batched_workspace = bw
        _verify_workspace_timed(
            bw, level=self.validate,
            context=f"compile_batched_spmm[{self.backend}]")

        def dev(arr: np.ndarray, dtype=torch.int32) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=dtype)

        self._consts = _FusedConsts(
            blk_tag=dev(bw.blk_tag), blk_off=dev(bw.blk_off),
            blk_coff=dev(bw.blk_coff), blk_L=dev(bw.blk_L),
            cols_flat=dev(bw.cols_flat),
            gather_flat=dev(bw.gather_flat, torch.int64),
            inv_perm=dev(bw.inv_perm, torch.int64),
            num_blocks=bw.num_blocks, merge_width=bw.merge_width,
            max_span=bw.max_span, max_cspan=bw.max_cspan)
        record_build_seconds("plan",
                             sum(p.plan_seconds for p in bw.request_plans))
        record_build_seconds("pack", bw.pack_seconds)
        self._row_splits = [int(v) for v in bw.row_splits]

    @property
    def n_requests(self) -> int:
        return len(self.shapes)

    def stack_inputs(self, xs) -> np.ndarray:
        """Host-side bucket padding: per-request ``(n_r, d_r <= d)``
        operands -> ONE zero-filled ``(R * x_rows_pad, d)`` float32
        host array (request r's rows at ``[r * x_rows_pad, ...)``)."""
        bw = self.batched_workspace
        out = np.zeros((bw.n_requests * bw.x_rows_pad, self.d), np.float32)
        for r, x in enumerate(xs):
            x = np.asarray(x, np.float32)
            out[r * bw.x_rows_pad:r * bw.x_rows_pad + x.shape[0],
                :x.shape[1]] = x
        return out

    def fused_operands(self, vals: torch.Tensor, x: torch.Tensor):
        """The fused kernel's arguments for one forward over the whole
        batch (positional, in the kernel's order) and its static knobs:
        the stacked tables, the gathered slot values of the concatenated
        ``vals`` and the stacked X, padded to the lane tile and passed
        through ``aligned16``."""
        fw = self._consts
        vals_ext = torch.cat([vals.float(),
                              vals.new_zeros(1, dtype=torch.float32)])
        vals_flat = vals_ext[fw.gather_flat]
        x_pad = aligned16(ccm.pad_cols(x.float(),
                                       self.d_tiling.d_pad).contiguous())
        if self.backend == "pallas_ell":
            return ((fw.blk_off, fw.blk_L, fw.cols_flat, vals_flat, x_pad),
                    dict(bm=self.bm, mw=fw.merge_width))
        return ((fw.blk_tag, fw.blk_off, fw.blk_coff, fw.blk_L,
                 fw.cols_flat, vals_flat, x_pad),
                dict(bm=self.bm, bk=self.bk, mw=fw.merge_width))

    def forward(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``vals``: every member's values concatenated in request order;
        ``x``: the stacked operand of :meth:`stack_inputs`, on the
        artifact's device.  One fused launch, then one ``inv_perm``
        gather that un-interleaves every request: the (sum m_r, d)
        output, request r's rows at ``row_splits[r]``."""
        bw, fw = self.batched_workspace, self._consts
        if tuple(x.shape) != (bw.n_requests * bw.x_rows_pad, self.d):
            raise ValueError(
                f"x must be the stacked ({bw.n_requests * bw.x_rows_pad}, "
                f"{self.d}) operand, got {tuple(x.shape)}")
        if tuple(vals.shape) != (bw.nnz,):
            raise ValueError(f"vals must hold the batch's {bw.nnz} values, "
                             f"got {tuple(vals.shape)}")
        for name, t in (("vals", vals), ("x", x)):
            if torch.device(self.device) != t.device:
                raise ValueError(f"{name} is on {t.device}, but this "
                                 f"artifact was compiled for {self.device}")
        if fw.num_blocks == 0:
            return torch.zeros((self._row_splits[-1], self.d),
                               dtype=torch.float32, device=x.device)
        operands, knobs = self.fused_operands(vals, x)
        op = (spmm_ell_fused_op if self.backend == "pallas_ell"
              else spmm_bcsr_fused_op)
        y_ws = op(*operands, **knobs, staging=self.staging,
                  span=fw.max_span, cspan=fw.max_cspan)
        return y_ws[fw.inv_perm, :self.d]

    def __call__(self, vals, xs):
        """``vals``: per-request value vectors (concatenated on the
        device with ``torch.cat``) or one pre-concatenated tensor;
        ``xs``: per-request host operands or the pre-stacked operand
        (host array or tensor).  Returns per-request ``(m_r, d)``
        outputs in request order."""
        if isinstance(vals, (list, tuple)):
            vals = torch.cat([torch.as_tensor(v, dtype=torch.float32,
                                              device=self.device).reshape(-1)
                              for v in vals])
        if isinstance(xs, (list, tuple)):
            xs = self.stack_inputs(xs)
        if isinstance(xs, np.ndarray):
            xs = torch.from_numpy(xs).to(self.device)
        with torch.no_grad():
            y = self.forward(vals, xs)
        rs = self._row_splits
        return [y[rs[r]:rs[r + 1]] for r in range(self.n_requests)]


def _normalize_batch_merge_threshold(merge_threshold, n_requests: int):
    """Scalar -> int; per-member sequence -> tuple of ints, collapsed
    back to the scalar when every member agrees so a uniform tuple and
    the plain scalar share one cache key (and one artifact)."""
    if np.ndim(merge_threshold) == 0:
        return int(merge_threshold)
    ts = tuple(int(t) for t in merge_threshold)
    if len(ts) != n_requests:
        raise ValueError(
            f"per-request merge_threshold needs {n_requests} entries, "
            f"got {len(ts)}")
    if len(set(ts)) == 1:
        return ts[0]
    return ts


def compile_batched_spmm(structures, d: int, *,
                         strategy: str = "nnz_split",
                         backend: str = "auto",
                         device: Optional[str] = None, bm: int = 8,
                         bk: int = 8, mxu_gain: float = 4.0,
                         staging: Optional[str] = None,
                         merge_threshold=0,
                         validate: Optional[str] = None,
                         cache_priority: float = 0.0,
                         cache: JitCache = GLOBAL_CACHE
                         ) -> CompiledBatchedSpmm:
    """Build (or fetch) the batched multi-tenant artifact (DESIGN.md
    §12): the cache key is the ORDERED tuple of member fingerprints plus
    every knob a solo key carries, ``device`` in the place of the
    reference's ``interpret`` — so an endpoint that sees the same batch
    composition twice plans and packs once.  ``merge_threshold`` may be
    one scalar or a per-member sequence (DESIGN.md §14.3);
    ``cache_priority`` is the artifact's SLA eviction score (§14.4)."""
    structures = tuple(structures)
    device = resolve_device(device)
    backend = _resolve_backend(backend, device, sharded=True)
    staging = _resolve_staging_for(backend, staging, device)
    merge_threshold = _normalize_batch_merge_threshold(
        merge_threshold, len(structures))
    validate = resolve_validate(validate, device)
    key = ("spmm_batch", tuple(a.fingerprint for a in structures), d,
           strategy, backend, bm, bk, mxu_gain, device, staging,
           merge_threshold, validate)
    return cache.get_or_build(
        key, lambda: CompiledBatchedSpmm(
            structures, d, strategy=strategy, backend=backend,
            device=device, bm=bm, bk=bk, mxu_gain=mxu_gain,
            staging=staging, merge_threshold=merge_threshold,
            validate=validate),
        priority=cache_priority)


def spmm(a: CSRMatrix, x: torch.Tensor, *, strategy: str = "nnz_split",
         backend: str = "auto", device: Optional[str] = None, bm: int = 8,
         bk: int = 8, mxu_gain: float = 4.0, staging: Optional[str] = None,
         merge_threshold: int = 0, validate: Optional[str] = None,
         mesh: Optional[ChipMesh] = None, n_chips: Optional[int] = None,
         x_sharding: Optional[str] = None, autotune: bool = False,
         measure=None, candidates=None, top_k: int = 3,
         cache: JitCache = GLOBAL_CACHE) -> torch.Tensor:
    """Y = A·X, specialized to A's structure and x's column count."""
    compiled = compile_spmm(a, x.shape[1], strategy=strategy,
                            backend=backend, device=device, bm=bm, bk=bk,
                            mxu_gain=mxu_gain, staging=staging,
                            merge_threshold=merge_threshold,
                            validate=validate, mesh=mesh, n_chips=n_chips,
                            x_sharding=x_sharding, autotune=autotune,
                            measure=measure, candidates=candidates,
                            top_k=top_k, cache=cache)
    return compiled(a.vals, x)


# -- the fused sparse-attention sandwich (DESIGN.md §13) ---------------------

def _to_device(arr: np.ndarray, device: str) -> torch.Tensor:
    """``arr`` on ``device``; to a card from pinned memory without a host
    wait (the first backward builds its tables inside a training step)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class _Attend(torch.autograd.Function):
    """The attention artifact's forward, over one instance or over a
    batch of instances sharing the mask (each its own launch), with the
    reference's custom VJP: the gradients of the plain-torch formulation
    (:meth:`CompiledSparseAttention._ref_vjp`, every instance at once); a
    gradient nobody asked for is not computed."""

    @staticmethod
    def forward(ctx, c: "CompiledSparseAttention", vals, q, k, v):
        ctx.c = c
        if q.dim() == 2:
            y = c._forward(vals, q, k, v)
        else:
            y = torch.stack([c._forward(vals, *t) for t in zip(q, k, v)])
        ctx.save_for_backward(vals, q, k, v, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        vals, q, k, v, y = ctx.saved_tensors
        return (None, *ctx.c._ref_vjp(vals, q, k, v, dy,
                                      ctx.needs_input_grad[1:], y))


class CompiledSparseAttention:
    """Structure-specialized sparse attention: out = softmax(mask ⊙
    (Q·Kᵀ)) · V, lowered as ONE fused launch (per chip, when sharded)
    through the same descriptor stream as SpMM (port of the reference's
    class of the same name, DESIGN.md §13).

    ``a`` is the (m queries × n keys) mask pattern; its values are the
    mask weights ``w`` (1.0 for a plain binary mask), giving ``p ∝ w ·
    exp(z)`` — softmax over the present entries.  Weights must be
    non-negative: ``w <= 0`` entries count as absent.  The plan is the
    sparse-einsum composition (``build_einsum_workspace``); Q reaches the
    kernel in workspace order through ``workspace_row_map``, and the
    score matrix never reaches device memory.

    Gradients: the backward is the gradient of :meth:`_ref_forward`,
    the plain-torch formulation, written out (:meth:`_ref_vjp`) and
    recomputed in chunks of whole query rows of at most ``SDDMM_CHUNK``
    gathered entries per operand (the reference takes ``jax.vjp`` of its
    jnp oracle).  It calls no kernel.  Called on (N, rows, width)
    operands, the N instances share the mask: each forward is a launch
    of its own, and one backward covers them all.

    Sharded (``mesh``/``n_chips``), each chip runs its rows' descriptor
    shard with Q in its own workspace order
    (``sharded_workspace_row_maps``) and K/V replicated — attention rows
    read arbitrary key columns, so X placement stays ``"replicated"``.
    """

    def __init__(self, a: CSRMatrix, dh: int, dv: Optional[int] = None, *,
                 strategy: str = "nnz_split", backend: str = "auto",
                 device: Optional[str] = None, bm: int = 8, bk: int = 8,
                 mxu_gain: float = 4.0, staging: Optional[str] = None,
                 merge_threshold: int = 0, sm_scale: Optional[float] = None,
                 validate: Optional[str] = None,
                 mesh: Optional[ChipMesh] = None,
                 n_chips: Optional[int] = None):
        self.device = resolve_device(device)
        self.backend = _resolve_backend(
            backend, self.device,
            sharded=mesh is not None or n_chips is not None)
        if self.backend == "dense":
            raise ValueError("sparse attention has no dense backend — use "
                             "ref as the oracle")
        self.mesh = _resolve_mesh_for(self.backend, mesh, n_chips,
                                      self.device)
        self.n_chips = None if self.mesh is None else self.mesh.size
        self.strategy = strategy
        self.bm = bm
        self.bk = bk
        self.mxu_gain = mxu_gain
        self.merge_threshold = int(merge_threshold)
        self.validate = resolve_validate(validate, self.device)
        self.staging = _resolve_staging_for(self.backend, staging,
                                            self.device)
        self.dh = int(dh)
        self.dv = int(dh) if dv is None else int(dv)
        self.sm_scale = (float(dh) ** -0.5 if sm_scale is None
                         else float(sm_scale))
        self.shape = a.shape
        self._row_ptr = a.row_ptr
        self._col_indices = a.col_indices
        self._fingerprint = a.fingerprint
        # the value width tiles the kernel's columns; the head width is
        # only padded (scores reduce over it whole)
        self.d_tiling = ccm.plan_d_tiles(self.dv, rows_in_flight=bm)
        self._dh_pad = ccm.plan_d_tiles(self.dh).d_pad
        # both trip kinds read K/V rows by (bk,) panels on the MXU side
        self._kv_rows_pad = -(-a.shape[1] // bk) * bk
        self._rows: Optional[torch.Tensor] = None
        self._cols: Optional[torch.Tensor] = None
        self._chunks: dict = {}

        self._fused: Optional[_FusedConsts] = None
        self._sharded: Optional[_ShardedConsts] = None
        self._row_map = None     # ws slot -> Q row (per chip when sharded)
        spec = (SPARSE_ATTN_MIXED_EINSUM if self.backend == "pallas_bcsr"
                else SPARSE_ATTN_EINSUM)
        if self.mesh is not None:
            sw = build_sharded_workspace(
                a.row_ptr, a.col_indices, a.shape, self.dv,
                n_chips=self.n_chips, strategy=strategy, row_block=bm,
                fingerprint=a.fingerprint, backend=self.backend, bk=bk,
                mxu_gain=mxu_gain, x_sharding="replicated",
                merge_threshold=self.merge_threshold)
            self.sharded_workspace = sw
            row_maps = sharded_workspace_row_maps(sw)
            if self.validate != "off":
                _verify_workspace_timed(
                    sw, level=self.validate, n_cols=a.shape[1], spec=spec,
                    vals=a.vals.detach().cpu().numpy(), row_map=row_maps,
                    context=f"compile_sparse_attention[{self.backend}"
                            f"/sharded]")
            self._sharded = _ShardedConsts.build(sw, self.mesh, self.device)
            self._row_map = place_on_chips(
                torch.from_numpy(row_maps.astype(np.int64)), self.mesh)
            record_build_seconds(
                "plan", sum(p.plan_seconds for p in sw.shard_plans))
            record_build_seconds("pack", sw.pack_seconds)
        elif self.backend in FUSED_BACKENDS:
            ws = build_einsum_workspace(
                spec, a.row_ptr, a.col_indices, a.shape, self.dv,
                strategy=strategy, row_block=bm, bk=bk, mxu_gain=mxu_gain,
                merge_threshold=self.merge_threshold,
                fingerprint=a.fingerprint)
            self.workspace = ws
            # verify the SAME forward map the Q gather ships
            row_map = workspace_row_map(ws.inv_perm, ws.ws_rows)
            if self.validate != "off":
                _verify_workspace_timed(
                    ws, level=self.validate, n_cols=a.shape[1], spec=spec,
                    vals=a.vals.detach().cpu().numpy(), row_map=row_map,
                    context=f"compile_sparse_attention[{self.backend}]")

            def dev(arr: np.ndarray, dtype=torch.int32) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(arr)).to(
                    device=self.device, dtype=dtype)

            self._fused = _FusedConsts(
                blk_tag=dev(ws.blk_tag), blk_off=dev(ws.blk_off),
                blk_coff=dev(ws.blk_coff), blk_L=dev(ws.blk_L),
                cols_flat=dev(ws.cols_flat),
                gather_flat=dev(ws.gather_flat, torch.int64),
                inv_perm=dev(ws.inv_perm, torch.int64),
                num_blocks=ws.num_blocks, merge_width=ws.merge_width,
                max_span=ws.max_span, max_cspan=ws.max_cspan)
            self._row_map = dev(row_map, torch.int64)
            record_build_seconds("pack", ws.pack_seconds)
        elif self.backend != "ref":
            raise ValueError(self.backend)

    def _expanded(self):
        """(nnz,) int64 query row and key column of every nonzero on the
        device, for the reference formulation (built on first use)."""
        if self._rows is None:
            self._rows = _to_device(np.repeat(
                np.arange(self.shape[0]), np.diff(self._row_ptr)),
                self.device)
            self._cols = _to_device(self._col_indices.astype(np.int64),
                                    self.device)
        return self._rows, self._cols

    def row_chunks(self, instances: int = 1):
        """``[(r0, r1), ...]``: the query rows in consecutive runs of at
        most ``SDDMM_CHUNK // (max(dh, dv) * instances)`` nonzeros (a
        longer row is a run of its own), so each run's gathered Q/K/V rows
        of ``instances`` instances stay within ``SDDMM_CHUNK`` entries per
        operand."""
        limit = max(1, SDDMM_CHUNK // (max(self.dh, self.dv, 1) * instances))
        rp, m = self._row_ptr, self.shape[0]
        chunks, r0 = [], 0
        while r0 < m:
            r1 = int(np.searchsorted(rp, rp[r0] + limit, side="right")) - 1
            r1 = min(max(r1, r0 + 1), m)
            chunks.append((r0, r1))
            r0 = r1
        return chunks

    def _chunk_index(self, r0: int, r1: int):
        """Rows ``[r0, r1)``'s nonzeros on the device: (their rows counted
        from ``r0``, their rows, their columns), int64, kept."""
        key = (r0, r1)
        if key not in self._chunks:
            rows, cols = self._expanded()
            p0, p1 = int(self._row_ptr[r0]), int(self._row_ptr[r1])
            self._chunks[key] = (rows[p0:p1] - r0, rows[p0:p1],
                                 cols[p0:p1])
        return self._chunks[key]

    def _ref_rows(self, vals, q, k, v, r0: int, r1: int) -> torch.Tensor:
        """The reference formulation for query rows ``[r0, r1)``:
        ``vals`` are those rows' nonzeros and ``q`` those rows.  The same
        ``p ∝ w · exp(z)`` semantics in segment ops, with the NaN-free
        clamp — ``w > 0`` entries never clamp (the row max dominates),
        ``w == 0`` ones are killed before they can overflow — and empty
        rows give 0."""
        rows, cols = self._expanded()
        p0, p1 = int(self._row_ptr[r0]), int(self._row_ptr[r1])
        rows, cols = rows[p0:p1] - r0, cols[p0:p1]
        mc = r1 - r0
        w = vals.float()
        z = (q.float()[rows] * k.float()[cols]).sum(-1) * self.sm_scale
        zm = torch.where(w > 0, z, torch.full_like(z, -1e30))
        zmax = torch.full((mc,), float("-inf"), device=z.device)
        zmax = zmax.scatter_reduce(0, rows, zm, "amax")
        zmax = torch.where(torch.isfinite(zmax), zmax, torch.zeros_like(zmax))
        p = w * torch.exp(torch.minimum(z - zmax[rows], torch.zeros_like(z)))
        denom = torch.zeros(mc, device=z.device).index_add(0, rows, p)
        out = torch.zeros((mc, self.dv), device=z.device).index_add(
            0, rows, p[:, None] * v.float()[cols])
        return out / torch.where(denom > 0, denom,
                                 torch.ones_like(denom))[:, None]

    def _ref_forward(self, vals, q, k, v) -> torch.Tensor:
        """The plain-torch oracle (the ``ref`` backend's forward), one
        chunk of query rows at a time."""
        out = torch.empty((self.shape[0], self.dv), dtype=torch.float32,
                          device=q.device)
        for r0, r1 in self.row_chunks():
            p0, p1 = self._row_ptr[r0], self._row_ptr[r1]
            out[r0:r1] = self._ref_rows(vals[p0:p1], q[r0:r1], k, v, r0, r1)
        return out

    def _ref_vjp(self, vals, q, k, v, dy, needs, y):
        """The gradients of :meth:`_ref_forward` for the inputs ``needs``
        marks (vals, q, k, v), of one instance or of N sharing the mask
        (q, k, v, dy of (N, rows, width); vals' gradient sums over them),
        written out rather than taken by autograd.  Over a row's
        nonzeros, with t = z − zmax, p = w·exp(min(t, 0)), D = Σ p (1
        where that is not > 0), P = p / D and out = Σ P·v: Δ = dy·out
        (0 where D is 1) gives dp = (dy·v − Δ) / D, dz = p·dp (0 where t
        clamps), dw = exp(min(t, 0))·dp, dq = scale·Σ dz·k, dk = scale·Σ
        dz·q and dv = Σ P·dy; zmax only shifts t, so it carries none.
        ``y`` is the forward's output.  Chunk by chunk of whole query
        rows (:meth:`row_chunks`): a row's dq and dw come from its chunk
        alone, and dk and dv add chunk after chunk in nonzero order, so
        chunking does not change them."""
        if not any(needs):
            return None, None, None, None
        one = q.dim() == 2
        if one:
            q, k, v, dy, y = (t[None] for t in (q, k, v, dy, y))
        n_inst = q.shape[0]
        w = vals.detach().float()
        absent = w <= 0
        qs = q.detach().float() * self.sm_scale
        k32, v32 = k.detach().float(), v.detach().float()
        dy = dy.float()
        delta = (dy * y.float()).sum(-1)                    # (N, m)
        dq = torch.zeros_like(qs) if needs[1] else None
        dk = torch.zeros_like(k32) if needs[2] else None
        dv = torch.zeros_like(v32) if needs[3] else None
        dw = torch.zeros_like(w) if needs[0] else None
        for r0, r1 in self.row_chunks(n_inst):
            p0, p1 = int(self._row_ptr[r0]), int(self._row_ptr[r1])
            if p1 == p0:
                continue    # empty rows: output 0 whatever the inputs
            local, rows, cols = self._chunk_index(r0, r1)
            wc = w[p0:p1]
            qr, kc = qs.index_select(1, rows), k32.index_select(1, cols)
            z = (qr * kc).sum(-1)                           # (N, nnz)
            zm = z.masked_fill(absent[p0:p1], -1e30)
            zmax = torch.full((n_inst, r1 - r0), float("-inf"),
                              device=z.device).scatter_reduce_(
                1, local.expand(n_inst, -1), zm, "amax")
            t = z - zmax.index_select(1, local)
            x = t.clamp(max=0).exp_()
            p = x * wc
            den = torch.zeros_like(zmax).index_add_(1, local, p)
            pos = den > 0
            dyr = dy.index_select(1, rows)
            dP = (dyr * v32.index_select(1, cols)).sum(-1)
            D = torch.where(pos, den, 1.0).index_select(1, local)
            dp = (dP - (delta[:, r0:r1] * pos).index_select(1, local)) / D
            if dw is not None:
                dw[p0:p1] = (x * dp).sum(0)
            dz = (p * dp).masked_fill_(t > 0, 0.0)[..., None]
            if dq is not None:
                dq.index_add_(1, rows, (dz * self.sm_scale) * kc)
            if dk is not None:
                dk.index_add_(1, cols, dz * qr)
            if dv is not None:
                dv.index_add_(1, cols, (p / D)[..., None] * dyr)
        out = [dw, dq, dk, dv]
        if one:
            out = [g if g is None or i == 0 else g[0]
                   for i, g in enumerate(out)]
        return tuple(None if g is None else g.to(t.dtype)
                     for g, t in zip(out, (vals, q, k, v)))

    def _check_operands(self, vals, q, k, v) -> None:
        m, n = self.shape
        for name, t, shape in (("vals", vals, (self._row_ptr[-1],)),
                               ("q", q, (m, self.dh)), ("k", k, (n, self.dh)),
                               ("v", v, (n, self.dv))):
            if tuple(t.shape) != tuple(int(s) for s in shape):
                raise ValueError(f"{name} must be {tuple(shape)}, got "
                                 f"{tuple(t.shape)}")
            if torch.device(self.device) != t.device:
                raise ValueError(f"{name} is on {t.device}, but this "
                                 f"artifact was compiled for {self.device}")

    # -- forward -----------------------------------------------------------
    def fused_operands(self, vals, q, k, v):
        """The fused kernel's arguments for one forward (positional, in
        the kernel's order) and its static knobs: the descriptor tables,
        the gathered mask weights, Q scaled, padded and gathered into
        workspace order, and K/V padded to the lane tile and to whole
        block-columns of rows."""
        fw = self._fused
        vals_ext, q_ext, k_pad, v_pad = self._staged(vals, q, k, v)
        return ((fw.blk_tag, fw.blk_off, fw.blk_coff, fw.blk_L, fw.cols_flat,
                 vals_ext[fw.gather_flat], q_ext[self._row_map], k_pad,
                 v_pad), dict(bm=self.bm, bk=self.bk, mw=fw.merge_width))

    def sharded_operands(self, vals, q, k, v):
        """The sharded wrapper's arguments for one forward: the per-chip
        tables, weights and workspace-ordered Q (each on its chip), K and
        V padded (the wrapper replicates them), and its knobs."""
        sw = self._sharded
        vals_ext, q_ext, k_pad, v_pad = self._staged(vals, q, k, v)
        q_ws = tuple(q_ext.to(dev)[rm]
                     for dev, rm in zip(sw.mesh.devices, self._row_map))
        return ((sw.blk_tag, sw.blk_off, sw.blk_coff, sw.blk_L, sw.cols_flat,
                 sw.chip_vals(vals_ext), q_ws, k_pad, v_pad),
                dict(mesh=sw.mesh, bm=self.bm, bk=self.bk,
                     mw=sw.merge_width))

    def _staged(self, vals, q, k, v):
        """The dense operands as the kernels take them: the weights with
        one zero slot appended, Q scaled and padded with one zero row
        appended (the row maps' sentinel), K/V padded to the lane tile
        and to whole block-columns of rows."""
        vals_ext = torch.cat([vals.float(),
                              vals.new_zeros(1, dtype=torch.float32)])
        q_pad = ccm.pad_cols(q.float() * self.sm_scale, self._dh_pad)
        q_ext = torch.cat([q_pad, q_pad.new_zeros((1, self._dh_pad))])
        k_pad = ccm.pad_cols(k.float(), self._dh_pad)
        v_pad = ccm.pad_cols(v.float(), self.d_tiling.d_pad)
        grow = self._kv_rows_pad - k_pad.shape[0]
        if grow > 0:
            k_pad = torch.nn.functional.pad(k_pad, (0, 0, 0, grow))
            v_pad = torch.nn.functional.pad(v_pad, (0, 0, 0, grow))
        return (vals_ext, q_ext, aligned16(k_pad.contiguous()),
                aligned16(v_pad.contiguous()))

    def _forward(self, vals, q, k, v) -> torch.Tensor:
        self._check_operands(vals, q, k, v)
        if self.backend == "ref":
            return self._ref_forward(vals, q, k, v)
        if self._sharded is not None:
            sw = self._sharded
            if sw.num_blocks == 0:
                return torch.zeros((self.shape[0], self.dv),
                                   dtype=torch.float32, device=q.device)
            operands, knobs = self.sharded_operands(vals, q, k, v)
            y_ws = attn_fused_sharded_op(*operands, **knobs,
                                         staging=self.staging,
                                         span=sw.chip_span,
                                         cspan=sw.chip_cspan)
            return sw.gather_rows(y_ws, self.dv, self.device)
        fw = self._fused
        if fw.num_blocks == 0:
            return torch.zeros((self.shape[0], self.dv), dtype=torch.float32,
                               device=q.device)
        operands, knobs = self.fused_operands(vals, q, k, v)
        y_ws = attn_fused_op(*operands, **knobs, staging=self.staging,
                             span=fw.max_span, cspan=fw.max_cspan)
        return y_ws[fw.inv_perm, :self.dv]

    def __call__(self, vals, q, k, v) -> torch.Tensor:
        """``out`` (m, dv) of ``q`` (m, dh), ``k`` (n, dh), ``v`` (n, dv);
        or of N instances sharing the mask, each (N, ...): (N, m, dv),
        every instance's forward a launch of its own."""
        return _Attend.apply(self, vals, q, k, v)


def compile_sparse_attention(a: CSRMatrix, dh: int, dv: Optional[int] = None,
                             *, strategy: str = "nnz_split",
                             backend: str = "auto",
                             device: Optional[str] = None, bm: int = 8,
                             bk: int = 8, mxu_gain: float = 4.0,
                             staging: Optional[str] = None,
                             merge_threshold: int = 0,
                             sm_scale: Optional[float] = None,
                             validate: Optional[str] = None,
                             mesh: Optional[ChipMesh] = None,
                             n_chips: Optional[int] = None,
                             cache: JitCache = GLOBAL_CACHE
                             ) -> CompiledSparseAttention:
    """Build (or fetch) the structure-specialized sparse-attention
    artifact, keyed like ``compile_spmm`` under the ``"attn"`` family:
    the mask fingerprint, both widths (head and value), the softmax
    scale and every resolved knob, ``device`` in the place of the
    reference's ``interpret``.  ``staging`` resolves to ``"dma"`` (K6)
    on the card and ``"resident"`` on the CPU; ``"resident"`` runs K5.
    ``mesh``/``n_chips`` shard the mask's rows over a chip mesh, as for
    ``compile_spmm`` (one K5/K6 launch per chip, K/V replicated); the
    resolved mesh joins the key."""
    device = resolve_device(device)
    backend = _resolve_backend(
        backend, device, sharded=mesh is not None or n_chips is not None)
    staging = _resolve_staging_for(backend, staging, device)
    mesh = _resolve_mesh_for(backend, mesh, n_chips, device)
    merge_threshold = int(merge_threshold)
    dv = int(dh) if dv is None else int(dv)
    sm_scale = float(dh) ** -0.5 if sm_scale is None else float(sm_scale)
    validate = resolve_validate(validate, device)
    key = ("attn", a.fingerprint, int(dh), dv, strategy, backend, bm, bk,
           mxu_gain, device, staging, merge_threshold, sm_scale, validate,
           mesh_fingerprint(mesh))
    return cache.get_or_build(
        key, lambda: CompiledSparseAttention(
            a, dh, dv, strategy=strategy, backend=backend, device=device,
            bm=bm, bk=bk, mxu_gain=mxu_gain, staging=staging,
            merge_threshold=merge_threshold, sm_scale=sm_scale,
            validate=validate, mesh=mesh))


def sparse_attention(a: CSRMatrix, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *, strategy: str = "nnz_split",
                     backend: str = "auto", device: Optional[str] = None,
                     bm: int = 8, bk: int = 8, mxu_gain: float = 4.0,
                     staging: Optional[str] = None, merge_threshold: int = 0,
                     sm_scale: Optional[float] = None,
                     validate: Optional[str] = None,
                     mesh: Optional[ChipMesh] = None,
                     n_chips: Optional[int] = None,
                     cache: JitCache = GLOBAL_CACHE) -> torch.Tensor:
    """One-shot convenience: softmax(mask ⊙ (Q·Kᵀ)) · V specialized to
    the mask's structure and the runtime head/value widths."""
    compiled = compile_sparse_attention(
        a, q.shape[1], v.shape[1], strategy=strategy, backend=backend,
        device=device, bm=bm, bk=bk, mxu_gain=mxu_gain, staging=staging,
        merge_threshold=merge_threshold, sm_scale=sm_scale,
        validate=validate, mesh=mesh, n_chips=n_chips, cache=cache)
    return compiled(a.vals, q, k, v)
