"""The card's peak rates and a cell's model FLOPs (port of the two
constants ``src/repro/analysis/roofline.py`` gives ``core.autotune`` and
of its ``model_flops_for_cell``).

The reference's roofline module also parses XLA's HLO text for compiled
dry-run artifacts (``RooflineTerms``, ``analyze``,
``parse_collective_bytes``); that part has no counterpart in an eager
PyTorch program and is not ported.  The two rates below are NVIDIA's
H100 SXM5 data sheet figures (dense, without sparsity, at the 700 W
power limit): float32 outside the tensor cores — the fused kernels' FFMA
trips — and the HBM3 bandwidth.  They are the rates ``chip_smoke.py``
states every kernel's bound against.  ``PEAK_FLOPS_BF16``, the dense
bf16 tensor-core rate, is the dry run's compute rate for a bf16 model's
matmuls (``peak_flops``).
"""
from __future__ import annotations

PEAK_FLOPS = 67e12           # fp32 FLOP/s, H100 SXM5, no tensor cores
PEAK_FLOPS_BF16 = 989e12     # bf16 FLOP/s, H100 SXM5 tensor cores, dense
HBM_BW = 3.35e12             # bytes/s, H100 SXM5 HBM3


def peak_flops(dtype: str) -> float:
    """The card's peak for a model computing in ``dtype`` (a config's
    ``dtype`` name): the tensor cores' bf16 rate, else float32's."""
    return PEAK_FLOPS_BF16 if dtype == "bfloat16" else PEAK_FLOPS


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train, dense) / 6·N_active·D (MoE); forward-
    only steps (prefill/decode) use 2·N·D."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_active * shape.global_batch
