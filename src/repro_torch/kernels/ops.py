"""Registries, knob resolvers and op wrappers around the Hopper kernels
(port of ``src/repro/kernels/ops.py``).

The reference resolves an ``interpret`` flag; the port resolves a
``device`` instead: ``None`` means the CUDA card, and a caller that
wants the CPU says ``device="cpu"``.  With no card and no explicit
``"cpu"`` the resolver raises — an entry point never quietly runs on
the CPU.  The resolved string joins every jit-cache key, exactly as
``interpret`` does in the reference.

Every op wrapper records a dispatch in ``DISPATCH_COUNTS`` (a plain
host counter, incremented once per kernel dispatch issued from Python) so
the Table IV invariant — one dispatch per (matrix, d) instance — reads
the same in both packages.  The kernels themselves keep their own
launch counts (``spmm_ell_fused.launches``), which move only when a
CUDA kernel is really launched.
"""
from __future__ import annotations

import collections

import torch

from ..distributed import chip_windows
from .attn_fused import attn_fused, attn_fused_sharded, attn_fused_staged
from .spmm_bcsr import spmm_bcsr
from .spmm_bcsr_fused import (spmm_bcsr_fused, spmm_bcsr_fused_sharded,
                              spmm_bcsr_fused_staged)
from .spmm_csr import spmm_ell_segment
from .spmm_ell_fused import (spmm_ell_fused, spmm_ell_fused_sharded,
                             spmm_ell_fused_staged)

# name -> number of fused dispatches issued (host-side)
DISPATCH_COUNTS: "collections.Counter[str]" = collections.Counter()

# The registry of every dispatch-count key any kernel entry point may
# increment — the reference's keys, one for one, so the accounting
# tests and tools/lint_invariants.py read both packages alike (the
# linter parses this literal and checks every increment site in src/
# against it).  The sharded wrappers count ``mesh.size`` under the
# per-launch keys and one call under ``*_sharded``, as the reference's do.
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


# fused-dispatch operand staging modes (DESIGN.md §7.7):
#   resident  K1/K2/K5 read the slot streams and X (Q/K/V) straight
#             from device memory — the CPU default and the bit-identity
#             oracle
#   dma       K3/K4/K6 stage each merged trip's slot and column window in
#             a shared-memory ring (and, in K3/K4, every step's X rows
#             too) — the card's default, as "dma" is the TPU's
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


def resolve_staging(staging=None, device: str = "cpu") -> str:
    """The effective staging mode for a RESOLVED device, same contract
    as :func:`resolve_device`: ``None``/``"auto"`` picks ``"dma"`` on a
    ``cuda:*`` device and ``"resident"`` on the CPU (where the staged
    kernels' plain versions are an oracle, not a win); the resolved
    string joins every jit-cache key that touches it."""
    if staging in (None, "auto"):
        return "resident" if device == "cpu" else "dma"
    if staging not in STAGING_MODES:
        raise ValueError(
            f"staging must be 'auto' or one of {STAGING_MODES}, "
            f"got {staging!r}")
    return staging


def _resolve_op_staging(staging, device: str, span: int, cspan: int) -> str:
    """Wrapper-level resolution: the staged kernels need the planner's
    windows, so a caller without them (a direct kernel-layer call that
    never built a workspace) is never auto-routed onto the staged path —
    ``auto`` falls back to resident, and an EXPLICIT ``"dma"`` without
    windows is an error."""
    if span > 0 and cspan > 0:
        return resolve_staging(staging, device)
    if staging == "dma":
        raise ValueError(
            "staging='dma' needs the workspace's staging windows "
            f"(span/cspan > 0, got span={span}, cspan={cspan}) — build "
            "them with build_fused_workspace")
    if staging not in (None, "auto", *STAGING_MODES):
        raise ValueError(
            f"staging must be 'auto' or one of {STAGING_MODES}, "
            f"got {staging!r}")
    return "resident"


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


def spmm_ell_segment_op(cols_pad_flat, vals_pad, x, *, bm: int = 8):
    DISPATCH_COUNTS["ell_segment"] += 1
    return spmm_ell_segment(cols_pad_flat, vals_pad, x, bm=bm)


def spmm_ell_fused_op(blk_off, blk_L, cols_flat, vals_flat, x, *,
                      bm: int = 8, mw: int = 1, staging=None,
                      span: int = 0, cspan: int = 0):
    """ONE dispatch for the whole plan, either staging mode; staged
    launches also count under ``ell_fused_dma`` so tests can assert
    WHICH lowering served a forward, and CGCM-merged launches (``mw >
    1``) under ``ell_fused_merged``."""
    staging = _resolve_op_staging(staging, str(x.device), span, cspan)
    DISPATCH_COUNTS["ell_fused"] += 1
    if mw > 1:
        DISPATCH_COUNTS["ell_fused_merged"] += 1
    if staging == "dma":
        DISPATCH_COUNTS["ell_fused_dma"] += 1
        return spmm_ell_fused_staged(blk_off, blk_L, cols_flat, vals_flat,
                                     x, span=span, cspan=cspan, bm=bm,
                                     mw=mw)
    return spmm_ell_fused(blk_off, blk_L, cols_flat, vals_flat, x,
                          bm=bm, mw=mw)


def spmm_bcsr_op(block_cols_pad, block_vals_pad, x, *, kmax: int):
    DISPATCH_COUNTS["bcsr"] += 1
    return spmm_bcsr(block_cols_pad, block_vals_pad, x, kmax=kmax)


def spmm_bcsr_fused_op(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                       vals_flat, x, *, bm: int = 8, bk: int = 8,
                       mw: int = 1, staging=None, span: int = 0,
                       cspan: int = 0):
    """ONE dispatch for a whole mixed VPU/MXU plan (Table IV invariant,
    covering the MXU block-rows as well); staged launches also count
    under ``bcsr_fused_dma``, CGCM-merged ones under
    ``bcsr_fused_merged``."""
    staging = _resolve_op_staging(staging, str(x.device), span, cspan)
    DISPATCH_COUNTS["bcsr_fused"] += 1
    if mw > 1:
        DISPATCH_COUNTS["bcsr_fused_merged"] += 1
    if staging == "dma":
        DISPATCH_COUNTS["bcsr_fused_dma"] += 1
        return spmm_bcsr_fused_staged(blk_tag, blk_off, blk_coff, blk_L,
                                      cols_flat, vals_flat, x, span=span,
                                      cspan=cspan, bm=bm, bk=bk, mw=mw)
    return spmm_bcsr_fused(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                           vals_flat, x, bm=bm, bk=bk, mw=mw)


def attn_fused_op(blk_tag, blk_off, blk_coff, blk_L, cols_flat, vals_flat,
                  q_ws, k, v, *, bm: int = 8, bk: int = 8, mw: int = 1,
                  staging=None, span: int = 0, cspan: int = 0):
    """ONE dispatch for the whole sparse-attention sandwich (SDDMM →
    masked softmax → S·V, DESIGN.md §13); staged launches also count
    under ``attn_fused_dma``, CGCM-merged ones under
    ``attn_fused_merged`` — the SpMM wrappers' accounting."""
    staging = _resolve_op_staging(staging, str(v.device), span, cspan)
    DISPATCH_COUNTS["attn_fused"] += 1
    if mw > 1:
        DISPATCH_COUNTS["attn_fused_merged"] += 1
    if staging == "dma":
        DISPATCH_COUNTS["attn_fused_dma"] += 1
        return attn_fused_staged(blk_tag, blk_off, blk_coff, blk_L,
                                 cols_flat, vals_flat, q_ws, k, v, span=span,
                                 cspan=cspan, bm=bm, bk=bk, mw=mw)
    return attn_fused(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                      vals_flat, q_ws, k, v, bm=bm, bk=bk, mw=mw)


def _sharded_staging(staging, mesh, span, cspan):
    """Per-chip windows and the staging of a sharded dispatch, resolved
    on the SMALLEST chip window as in the reference: a chip without a
    window routes ``auto`` to resident for every chip, and an explicit
    ``"dma"`` then raises.  Resident calls zero the windows."""
    span = chip_windows(span, mesh.size)
    cspan = chip_windows(cspan, mesh.size)
    staging = _resolve_op_staging(staging, str(mesh.devices[0]), min(span),
                                  min(cspan))
    if staging != "dma":
        span = cspan = (0,) * mesh.size
    return staging, span, cspan


def spmm_ell_fused_sharded_op(blk_off, blk_L, cols_flat, vals_flat, x, *,
                              mesh, bm: int = 8, mw: int = 1, staging=None,
                              span=0, cspan=0, x_sharding: str = "replicated",
                              x_send=None, x_recv=None):
    """One fused dispatch per chip: ``mesh.size`` under ``ell_fused`` (the
    per-forward invariant) plus one ``ell_fused_sharded`` call —
    ``mesh.size`` under ``ell_fused_dma`` when staged, under
    ``ell_fused_xshard`` when X is row-sharded, and under
    ``ell_fused_merged`` when ``mw > 1``."""
    staging, span, cspan = _sharded_staging(staging, mesh, span, cspan)
    DISPATCH_COUNTS["ell_fused"] += mesh.size
    DISPATCH_COUNTS["ell_fused_sharded"] += 1
    if mw > 1:
        DISPATCH_COUNTS["ell_fused_merged"] += mesh.size
    if x_sharding == "rows":
        DISPATCH_COUNTS["ell_fused_xshard"] += mesh.size
    if staging == "dma":
        DISPATCH_COUNTS["ell_fused_dma"] += mesh.size
    return spmm_ell_fused_sharded(blk_off, blk_L, cols_flat, vals_flat, x,
                                  mesh=mesh, bm=bm, mw=mw, staging=staging,
                                  span=span, cspan=cspan,
                                  x_sharding=x_sharding, x_send=x_send,
                                  x_recv=x_recv)


def spmm_bcsr_fused_sharded_op(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                               vals_flat, x, *, mesh, bm: int = 8,
                               bk: int = 8, mw: int = 1, staging=None,
                               span=0, cspan=0,
                               x_sharding: str = "replicated", x_send=None,
                               x_recv=None):
    """One mixed fused dispatch per chip: ``mesh.size`` under
    ``bcsr_fused`` plus one ``bcsr_fused_sharded`` call, with the ELL
    twin's ``_dma``/``_xshard``/``_merged`` accounting."""
    staging, span, cspan = _sharded_staging(staging, mesh, span, cspan)
    DISPATCH_COUNTS["bcsr_fused"] += mesh.size
    DISPATCH_COUNTS["bcsr_fused_sharded"] += 1
    if mw > 1:
        DISPATCH_COUNTS["bcsr_fused_merged"] += mesh.size
    if x_sharding == "rows":
        DISPATCH_COUNTS["bcsr_fused_xshard"] += mesh.size
    if staging == "dma":
        DISPATCH_COUNTS["bcsr_fused_dma"] += mesh.size
    return spmm_bcsr_fused_sharded(blk_tag, blk_off, blk_coff, blk_L,
                                   cols_flat, vals_flat, x, mesh=mesh, bm=bm,
                                   bk=bk, mw=mw, staging=staging, span=span,
                                   cspan=cspan, x_sharding=x_sharding,
                                   x_send=x_send, x_recv=x_recv)


def attn_fused_sharded_op(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                          vals_flat, q_ws, k, v, *, mesh, bm: int = 8,
                          bk: int = 8, mw: int = 1, staging=None, span=0,
                          cspan=0):
    """One fused attention dispatch per chip: ``mesh.size`` under
    ``attn_fused`` plus one ``attn_fused_sharded`` call, ``mesh.size``
    under ``attn_fused_dma`` when staged — K/V are replicated, so there
    is no ``_xshard`` variant."""
    staging, span, cspan = _sharded_staging(staging, mesh, span, cspan)
    DISPATCH_COUNTS["attn_fused"] += mesh.size
    DISPATCH_COUNTS["attn_fused_sharded"] += 1
    if mw > 1:
        DISPATCH_COUNTS["attn_fused_merged"] += mesh.size
    if staging == "dma":
        DISPATCH_COUNTS["attn_fused_dma"] += mesh.size
    return attn_fused_sharded(blk_tag, blk_off, blk_coff, blk_L, cols_flat,
                              vals_flat, q_ws, k, v, mesh=mesh, bm=bm, bk=bk,
                              mw=mw, staging=staging, span=span, cspan=cspan)
