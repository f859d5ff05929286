# Hand-written Hopper kernels for the port's hot spots, each with a plain
# PyTorch version beside it (what the CPU tests run and what the card's
# results are held against):
#   spmm_ell_fused          K1 — the whole multi-segment ELL plan in one
#                           launch (csrc/spmm_ell_fused.cu; replaces
#                           src/repro/kernels/spmm_ell_fused.py::
#                           spmm_ell_fused)
#   spmm_bcsr_fused         K2 — the mixed VPU/MXU plan in one launch
#                           (csrc/spmm_bcsr_fused.cu; replaces
#                           src/repro/kernels/spmm_bcsr_fused.py::
#                           spmm_bcsr_fused)
#   spmm_ell_fused_staged   K3 — K1 with each trip's windows staged through
#                           a double-buffered shared-memory ring
#                           (csrc/spmm_ell_fused_staged.cu; replaces
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
# ops.py holds the device/staging/validate resolvers and the
# DISPATCH_COUNTS host counter the Table IV invariant tests read; the
# sharded and SDDMM kernels come in later slices.
from . import ops, ref
from .attn_fused import (attn_fused, attn_fused_plain, attn_fused_staged,
                         attn_fused_staged_plain)
from .spmm_bcsr_fused import (spmm_bcsr_fused, spmm_bcsr_fused_plain,
                              spmm_bcsr_fused_staged,
                              spmm_bcsr_fused_staged_plain)
from .spmm_ell_fused import (spmm_ell_fused, spmm_ell_fused_plain,
                             spmm_ell_fused_staged,
                             spmm_ell_fused_staged_plain)

__all__ = ["attn_fused", "attn_fused_plain", "attn_fused_staged",
           "attn_fused_staged_plain", "ops", "ref", "spmm_bcsr_fused", "spmm_bcsr_fused_plain",
           "spmm_bcsr_fused_staged", "spmm_bcsr_fused_staged_plain",
           "spmm_ell_fused", "spmm_ell_fused_plain",
           "spmm_ell_fused_staged", "spmm_ell_fused_staged_plain"]
