"""Registries, knob resolvers and op wrappers around the Hopper kernels
(port of ``src/repro/kernels/ops.py``).

The reference resolves an ``interpret`` flag; the port resolves a
``device`` instead: ``None`` means the CUDA card, and a caller that
wants the CPU says ``device="cpu"``.  With no card and no explicit
``"cpu"`` the resolver raises — an entry point never quietly runs on
the CPU.  The resolved string joins every jit-cache key, exactly as
``interpret`` does in the reference.

Every op wrapper records a dispatch in ``DISPATCH_COUNTS`` (a plain
host counter, incremented once per fused launch issued from Python) so
the Table IV invariant — one dispatch per (matrix, d) instance — reads
the same in both packages.  The kernels themselves keep their own
launch counts (``spmm_ell_fused.launches``), which move only when a
CUDA kernel is really launched.
"""
from __future__ import annotations

import collections

import torch

from .spmm_bcsr_fused import spmm_bcsr_fused
from .spmm_ell_fused import spmm_ell_fused

# name -> number of fused dispatches issued (host-side)
DISPATCH_COUNTS: "collections.Counter[str]" = collections.Counter()

# The registry of every dispatch-count key any kernel entry point may
# increment — the reference's keys, one for one, so the accounting
# tests and tools/lint_invariants.py read both packages alike (the
# linter parses this literal and checks every increment site in src/
# against it).  Keys for paths this slice does not port yet (staged,
# sharded, attention, sddmm) are incremented only by the reference.
DISPATCH_KEYS = frozenset({
    # per-launch invariant keys (one per plan, n_chips when sharded)
    "ell_segment", "ell_fused", "bcsr", "bcsr_fused", "attn_fused",
    "sddmm",
    # lowering-variant keys: WHICH path served a forward
    "ell_fused_merged", "ell_fused_dma", "ell_fused_sharded",
    "ell_fused_xshard",
    "bcsr_fused_merged", "bcsr_fused_dma", "bcsr_fused_sharded",
    "bcsr_fused_xshard",
    "attn_fused_merged", "attn_fused_dma", "attn_fused_sharded",
})

# kind -> accumulated host seconds spent building plans/packings ("plan"
# covers build/merge/tag, "pack" the descriptor-table packing, "verify"
# the static plan verifier — exactly 0.0 under validate="off").  Reset
# together with DISPATCH_COUNTS.
BUILD_SECONDS: "collections.Counter[str]" = collections.Counter()


def record_build_seconds(kind: str, seconds: float) -> None:
    """Accumulate host-side build cost under ``kind`` (see
    :data:`BUILD_SECONDS`)."""
    BUILD_SECONDS[kind] += float(seconds)


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()
    BUILD_SECONDS.clear()


# fused-dispatch operand staging modes (DESIGN.md §7.7).  On the GPU
# "resident" means the slot streams stay in device memory and are read
# through L2; "dma" — the staged kernels K3/K4 — is queued for the next
# slice, and ``auto`` flips to it on cuda when they land.
STAGING_MODES = ("resident", "dma")


def resolve_device(device=None) -> str:
    """The effective device — resolved ONCE so jit-cache keys and kernel
    launches agree: ``"cpu"`` or ``"cuda:<index>"``.  ``None`` means the
    current CUDA device and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cpu' or a CUDA device, "
                         f"got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but no CUDA device is "
                           f"available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return f"cuda:{index}"


def resolve_staging(staging=None) -> str:
    """The effective staging mode, same contract as
    :func:`resolve_device`: ``None``/``"auto"``/``"resident"`` resolve to
    ``"resident"`` in this slice; ``"dma"`` needs the staged kernels."""
    if staging in (None, "auto", "resident"):
        return "resident"
    if staging == "dma":
        raise NotImplementedError(
            "staging='dma' runs the staged kernels K3/K4 "
            "(spmm_ell_fused_staged / spmm_bcsr_fused_staged), which are "
            "queued for the next slice of the port")
    raise ValueError(
        f"staging must be 'auto' or one of {STAGING_MODES}, "
        f"got {staging!r}")


def resolve_validate(validate=None, device: str = "cpu") -> str:
    """The effective verification level (DESIGN.md §15) for a RESOLVED
    device: ``None``/``"auto"`` picks ``"full"`` on the CPU (every test
    verifies every workspace it builds) and ``"off"`` on the card (zero
    host cost on the dispatch path); the resolved string joins the
    jit-cache keys."""
    from ..analysis.verify import VALIDATE_MODES   # lazy: verify imports core
    if validate in (None, "auto"):
        return "full" if device == "cpu" else "off"
    if validate not in VALIDATE_MODES:
        raise ValueError(
            f"validate must be 'auto' or one of {VALIDATE_MODES}, "
            f"got {validate!r}")
    return validate


def spmm_ell_fused_op(blk_off, blk_L, cols_flat, vals_flat, x, *,
                      bm: int = 8, mw: int = 1, staging=None):
    """ONE dispatch for the whole plan; CGCM-merged launches (``mw >
    1``) also count under ``ell_fused_merged``."""
    resolve_staging(staging)
    DISPATCH_COUNTS["ell_fused"] += 1
    if mw > 1:
        DISPATCH_COUNTS["ell_fused_merged"] += 1
    return spmm_ell_fused(blk_off, blk_L, cols_flat, vals_flat, x,
                          bm=bm, mw=mw)


def spmm_bcsr_fused_op(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                       vals_flat, x, *, bm: int = 8, bk: int = 8,
                       mw: int = 1, staging=None):
    """ONE dispatch for a whole mixed VPU/MXU plan (Table IV invariant,
    covering the MXU block-rows as well); CGCM-merged launches also
    count under ``bcsr_fused_merged``."""
    resolve_staging(staging)
    DISPATCH_COUNTS["bcsr_fused"] += 1
    if mw > 1:
        DISPATCH_COUNTS["bcsr_fused_merged"] += 1
    return spmm_bcsr_fused(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                           vals_flat, x, bm=bm, bk=bk, mw=mw)
