# Port of src/repro/analysis/: the static plan-IR verifier (numpy only).
from .verify import (PlanVerificationError, PlanViolation, check_workspace,
                     verify_attention_contract, verify_batched_workspace,
                     verify_fused_workspace, verify_sharded_workspace,
                     verify_workspace)

__all__ = ["PlanVerificationError", "PlanViolation", "check_workspace",
           "verify_attention_contract", "verify_batched_workspace",
           "verify_fused_workspace", "verify_sharded_workspace",
           "verify_workspace"]
