# Hand-written Hopper kernels for the port's hot spots, each with a plain
# PyTorch version beside it (what the CPU tests run and what the card's
# results are held against):
#   spmm_ell_fused          K1 — the whole multi-segment ELL plan in one
#                           launch, on K2's gather ring at planned widths
#                           (csrc/spmm_ell_fused.cu; replaces
#                           src/repro/kernels/spmm_ell_fused.py::
#                           spmm_ell_fused)
#   spmm_bcsr_fused         K2 — the mixed VPU/MXU plan in one launch
#                           (csrc/spmm_bcsr_fused.cu; replaces
#                           src/repro/kernels/spmm_bcsr_fused.py::
#                           spmm_bcsr_fused)
#   spmm_ell_fused_staged   K3 — K1 with each trip's windows and X rows
#                           staged by a producer warp through shared-memory
#                           rings (csrc/spmm_ell_fused_staged.cu; replaces
#                           spmm_ell_fused.py::spmm_ell_fused_staged)
#   spmm_bcsr_fused_staged  K4 — K2 staged the same way, X included
#                           (csrc/spmm_bcsr_fused_staged.cu; replaces
#                           spmm_bcsr_fused.py::spmm_bcsr_fused_staged)
#   attn_fused              K5 — the sparse-attention sandwich (SDDMM score,
#                           online softmax, S·V) in one launch
#                           (csrc/attn_fused.cu; replaces
#                           src/repro/kernels/attn_fused.py::attn_fused)
#   attn_fused_staged       K6 — K5 with the weight and column windows
#                           staged through K3/K4's ring
#                           (csrc/attn_fused_staged.cu; replaces
#                           attn_fused.py::attn_fused_staged)
#   sddmm                   K7 — the SDDMM dA.vals = <dY[row], X[col]>,
#                           persistent warps over runs of 32 pairs
#                           (csrc/sddmm.cu; replaces
#                           src/repro/kernels/sddmm.py::sddmm); the fused
#                           SpMM backward's dvals, and sddmm_csr, its entry
#                           point on a CSR structure
#   spmm_ell_segment        K9 — one ELL segment, the per-segment
#                           micro-oracle, on K2's gather ring
#                           (csrc/spmm_ell_segment.cu; replaces
#                           src/repro/kernels/spmm_csr.py::spmm_ell_segment)
#   spmm_bcsr               K10 — the pre-fusion block-CSR micro-oracle at
#                           a global kmax, on K2's gather ring at planned
#                           widths (csrc/spmm_bcsr.cu; replaces
#                           src/repro/kernels/spmm_bcsr.py::spmm_bcsr)
#   spmm_ell_fused_sharded  K8 — one K1/K3 (K2/K4, K5/K6) launch per chip of
#   spmm_bcsr_fused_sharded a ChipMesh, after the exact-panel X exchange
#   attn_fused_sharded      when X is row-sharded; no device code of its
#                           own (replaces the three *_sharded wrappers of
#                           src/repro/kernels/{spmm_ell_fused,
#                           spmm_bcsr_fused,attn_fused}.py)
# ops.py holds the device/staging/validate resolvers and the
# DISPATCH_COUNTS host counter the Table IV invariant tests read.
from . import ops, ref
from .attn_fused import (attn_fused, attn_fused_plain, attn_fused_sharded,
                         attn_fused_sharded_plain, attn_fused_staged,
                         attn_fused_staged_plain)
from .sddmm import sddmm, sddmm_csr, sddmm_plain
from .spmm_bcsr import spmm_bcsr, spmm_bcsr_plain
from .spmm_bcsr_fused import (spmm_bcsr_fused, spmm_bcsr_fused_plain,
                              spmm_bcsr_fused_sharded,
                              spmm_bcsr_fused_sharded_plain,
                              spmm_bcsr_fused_staged,
                              spmm_bcsr_fused_staged_plain)
from .spmm_ell_fused import (spmm_ell_fused, spmm_ell_fused_plain,
                             spmm_ell_fused_sharded,
                             spmm_ell_fused_sharded_plain,
                             spmm_ell_fused_staged,
                             spmm_ell_fused_staged_plain)
from .spmm_csr import spmm_ell_segment, spmm_ell_segment_plain

__all__ = ["attn_fused", "attn_fused_plain", "attn_fused_sharded",
           "attn_fused_sharded_plain", "attn_fused_staged",
           "attn_fused_staged_plain", "ops", "ref", "sddmm", "sddmm_csr",
           "sddmm_plain", "spmm_bcsr", "spmm_bcsr_plain", "spmm_bcsr_fused",
           "spmm_bcsr_fused_plain", "spmm_bcsr_fused_sharded",
           "spmm_bcsr_fused_sharded_plain", "spmm_bcsr_fused_staged",
           "spmm_bcsr_fused_staged_plain", "spmm_ell_fused",
           "spmm_ell_fused_plain", "spmm_ell_fused_sharded",
           "spmm_ell_fused_sharded_plain", "spmm_ell_fused_staged",
           "spmm_ell_fused_staged_plain", "spmm_ell_segment",
           "spmm_ell_segment_plain"]
