# Hand-written Hopper kernels for the port's hot spots, each with a plain
# PyTorch version beside it (what the CPU tests run and what the card's
# results are held against):
#   spmm_ell_fused   K1 — the whole multi-segment ELL plan in one launch
#                    (csrc/spmm_ell_fused.cu; replaces the TPU kernel
#                    src/repro/kernels/spmm_ell_fused.py::spmm_ell_fused)
#   spmm_bcsr_fused  K2 — the mixed VPU/MXU plan in one launch
#                    (csrc/spmm_bcsr_fused.cu; replaces
#                    src/repro/kernels/spmm_bcsr_fused.py::spmm_bcsr_fused)
# ops.py holds the device/staging/validate resolvers and the
# DISPATCH_COUNTS host counter the Table IV invariant tests read; the
# staged, sharded, attention and SDDMM kernels come in later slices.
from . import ops, ref
from .spmm_bcsr_fused import spmm_bcsr_fused, spmm_bcsr_fused_plain
from .spmm_ell_fused import spmm_ell_fused, spmm_ell_fused_plain

__all__ = ["ops", "ref", "spmm_bcsr_fused", "spmm_bcsr_fused_plain",
           "spmm_ell_fused", "spmm_ell_fused_plain"]
