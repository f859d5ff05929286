"""Public JIT-SpMM API: Y = A·X specialized to the runtime instance
(port of ``src/repro/core/spmm.py``, single device, forward only).

``compile_spmm`` is the paper's "JIT code generator": given the concrete
structure of A and the runtime-known d, it plans on the host, checks the
workspace, moves the descriptor tables to the device once, and caches
the resulting ``CompiledSpmm`` under everything the specialization
depends on.  ``spmm`` is the one-shot convenience wrapper.

Backends (the reference's names, so tests compare like with like):
  pallas_ell   K1: the whole multi-segment ELL plan is ONE launch of
               ``kernels/csrc/spmm_ell_fused.cu`` plus one
               inverse-permutation gather.
  pallas_bcsr  K2: the MIXED plan — each bm-aligned row-block tagged VPU
               (gather+FMA) or MXU ((bm x bk) block products) — is still
               ONE launch, of ``kernels/csrc/spmm_bcsr_fused.cu``.
  ref          plain torch gather + ``index_add_``.
  dense        densified matmul (tiny tests only).

``backend="auto"`` resolves to ``pallas_bcsr`` on the card and ``ref`` on
the CPU, as the reference picks ``pallas_bcsr`` on a TPU.  ``device``
takes the place of the reference's ``interpret`` knob: resolved once
(``None`` = the CUDA card, raising when there is none), it joins every
cache key.  On the CPU the fused backends run the kernels' plain
versions.  Still to come in later slices, and absent from the
signature until then: the backward pass, ``staging="dma"``, the sharded
path (``mesh``/``n_chips``/``x_sharding``) and autotuning.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import ccm
from .csr import CSRMatrix
from .jit_cache import GLOBAL_CACHE, JitCache
from .plan import (MixedPlan, SpmmPlan, build_fused_workspace,
                   build_mixed_plan, build_plan, choose_merge_width)
from ..analysis.verify import PlanVerificationError, check_workspace
from ..kernels.ops import (record_build_seconds, resolve_device,
                           resolve_staging, resolve_validate,
                           spmm_bcsr_fused_op, spmm_ell_fused_op)
from ..kernels.ref import spmm_coo_ref, spmm_dense_ref

__all__ = ["BACKENDS", "FUSED_BACKENDS", "CompiledSpmm",
           "PlanVerificationError", "compile_spmm", "spmm"]

BACKENDS = ("pallas_ell", "pallas_bcsr", "ref", "dense", "auto")

# backends that lower through the fused descriptor-table launch (and
# therefore take the staging knob)
FUSED_BACKENDS = ("pallas_ell", "pallas_bcsr")


def _resolve_backend(backend: str, device: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend != "auto":
        return backend
    # the mixed fused path on the card: MXU trips where block structure
    # pays, VPU trips elsewhere; the plain oracle on the CPU
    return "ref" if device == "cpu" else "pallas_bcsr"


def _resolve_staging_for(backend: str, staging) -> str:
    """Per-backend staging resolution: the knob only exists on the fused
    launch, so non-fused backends pin ``"resident"`` and reject an
    explicit ``"dma"`` — keeping ref/dense cache keys independent of a
    knob they ignore."""
    if backend in FUSED_BACKENDS:
        return resolve_staging(staging)
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


class CompiledSpmm:
    """The "jit-function": structure-specialized, value-generic SpMM on
    one device.  Forward only in this slice.  On the fused backends the
    host workspace it was packed from stays readable as ``workspace``."""

    def __init__(self, a: CSRMatrix, d: int, *, strategy: str,
                 backend: str, device: Optional[str] = None, bm: int = 8,
                 bk: int = 8, mxu_gain: float = 4.0,
                 staging: Optional[str] = None, merge_threshold: int = 0,
                 validate: Optional[str] = None):
        # resolved ONCE: the effective device is part of the compiled
        # artifact's identity (and of every jit-cache key touching it)
        self.device = resolve_device(device)
        self.backend = _resolve_backend(backend, self.device)
        self.strategy = strategy
        self.bm = bm
        self.bk = bk
        self.mxu_gain = mxu_gain
        self.merge_threshold = int(merge_threshold)
        self.validate = resolve_validate(validate, self.device)
        self.staging = _resolve_staging_for(self.backend, staging)
        self.d = d
        self.shape = a.shape
        # the mixed kernel slices (bk, d_pad) X panels per block-column,
        # so X rows are padded up to the block-column grid
        self._x_rows_pad = -(-a.shape[1] // bk) * bk

        def dev(arr: np.ndarray, dtype=torch.int32) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=self.device, dtype=dtype)

        self.plan: Optional[SpmmPlan] = None
        self.mixed_plan: Optional[MixedPlan] = None
        self._fused: Optional[_FusedConsts] = None
        if self.backend == "pallas_bcsr":
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

        if self.backend in FUSED_BACKENDS:
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
                num_blocks=ws.num_blocks, merge_width=ws.merge_width)
            record_build_seconds("plan", plan.plan_seconds)
            record_build_seconds("pack", ws.pack_seconds)
        else:
            # the row expansion is pure structure — precompute it so the
            # serving path never repeats the host-side np.repeat
            self._rows = dev(np.repeat(np.arange(a.shape[0]),
                                       a.row_lengths), torch.int64)
            self._cols = dev(a.col_indices, torch.int64)

    # -- forward -----------------------------------------------------------
    def _check_operands(self, vals: torch.Tensor, x: torch.Tensor) -> None:
        if vals.requires_grad or x.requires_grad:
            raise NotImplementedError(
                "backward: a later slice of the port (the reference's "
                "custom_vjp becomes a torch.autograd.Function there)")
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
        fw = self._fused
        if fw.num_blocks == 0:
            return torch.zeros((m, d), dtype=torch.float32, device=x.device)
        operands, knobs = self.fused_operands(vals, x)
        op = (spmm_ell_fused_op if backend == "pallas_ell"
              else spmm_bcsr_fused_op)
        y_ws = op(*operands, **knobs, staging=self.staging)
        # single inverse-permutation gather restores row order
        return y_ws[fw.inv_perm, :d]

    def fused_operands(self, vals: torch.Tensor, x: torch.Tensor):
        """The fused kernel's arguments for one forward: the descriptor
        tables, the gathered slot values and the padded X (positional,
        in the kernel's order), and its static knobs.  Gathering the
        values is the forward's one pass over ``vals``."""
        fw = self._fused
        vals_ext = torch.cat([vals.float(),
                              vals.new_zeros(1, dtype=torch.float32)])
        vals_flat = vals_ext[fw.gather_flat]
        x_pad = ccm.pad_cols(x.float(), self.d_tiling.d_pad)
        if self.backend == "pallas_ell":
            return ((fw.blk_off, fw.blk_L, fw.cols_flat, vals_flat,
                     x_pad.contiguous()),
                    dict(bm=self.bm, mw=fw.merge_width))
        if x_pad.shape[0] < self._x_rows_pad:
            x_pad = torch.nn.functional.pad(
                x_pad, (0, 0, 0, self._x_rows_pad - x_pad.shape[0]))
        return ((fw.blk_tag, fw.blk_off, fw.blk_coff, fw.blk_L,
                 fw.cols_flat, vals_flat, x_pad.contiguous()),
                dict(bm=self.bm, bk=self.bk, mw=fw.merge_width))

    def __call__(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self._forward(vals, x)


def compile_spmm(a: CSRMatrix, d: int, *, strategy: str = "nnz_split",
                 backend: str = "auto", device: Optional[str] = None,
                 bm: int = 8, bk: int = 8, mxu_gain: float = 4.0,
                 staging: Optional[str] = None, merge_threshold: int = 0,
                 validate: Optional[str] = None,
                 cache: JitCache = GLOBAL_CACHE) -> CompiledSpmm:
    """Build (or fetch) the structure-specialized SpMM artifact.

    ``device`` is resolved once (``None`` = the CUDA card; pass
    ``"cpu"`` to run the kernels' plain versions) and is part of the
    cache key, like every other knob here.  ``bk`` / ``mxu_gain``
    parameterize the pallas_bcsr mixed plan (block width, VPU-vs-MXU
    tagging).  ``staging`` accepts ``"auto"``/``"resident"``; ``"dma"``
    raises until the staged kernels land.  ``merge_threshold`` drives
    the CGCM merge stage (DESIGN.md §7.9): 0 disables merging, a
    positive value lets up to ``MAX_MERGE_WIDTH`` short block-rows share
    one CTA; the output is identical either way.  ``validate`` runs the
    static plan verifier (DESIGN.md §15): ``"off"`` / ``"cheap"`` /
    ``"full"``, with ``"auto"``/``None`` resolving to ``"full"`` on the
    CPU and ``"off"`` on the card."""
    device = resolve_device(device)
    backend = _resolve_backend(backend, device)
    staging = _resolve_staging_for(backend, staging)
    merge_threshold = int(merge_threshold)
    validate = resolve_validate(validate, device)
    key = ("spmm", a.fingerprint, d, strategy, backend, bm, bk, mxu_gain,
           device, staging, merge_threshold, validate)
    return cache.get_or_build(
        key, lambda: CompiledSpmm(a, d, strategy=strategy, backend=backend,
                                  device=device, bm=bm, bk=bk,
                                  mxu_gain=mxu_gain, staging=staging,
                                  merge_threshold=merge_threshold,
                                  validate=validate))


def spmm(a: CSRMatrix, x: torch.Tensor, *, strategy: str = "nnz_split",
         backend: str = "auto", device: Optional[str] = None, bm: int = 8,
         bk: int = 8, mxu_gain: float = 4.0, staging: Optional[str] = None,
         merge_threshold: int = 0, validate: Optional[str] = None,
         cache: JitCache = GLOBAL_CACHE) -> torch.Tensor:
    """Y = A·X, specialized to A's structure and x's column count."""
    compiled = compile_spmm(a, x.shape[1], strategy=strategy,
                            backend=backend, device=device, bm=bm, bk=bk,
                            mxu_gain=mxu_gain, staging=staging,
                            merge_threshold=merge_threshold,
                            validate=validate, cache=cache)
    return compiled(a.vals, x)
