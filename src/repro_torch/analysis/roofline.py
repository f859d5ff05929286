"""The card's peak rates, for the autotuner's cost model (port of the two
constants ``src/repro/analysis/roofline.py`` gives ``core.autotune``).

The reference's roofline module also parses XLA's HLO text for compiled
dry-run artifacts; that part has no counterpart in an eager PyTorch
program and is not ported.  The two rates below are NVIDIA's H100 SXM5
data sheet figures (dense, without sparsity, at the 700 W power limit):
float32 outside the tensor cores — the fused kernels' FFMA trips — and
the HBM3 bandwidth.  They are the rates ``chip_smoke.py`` states every
kernel's bound against.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12           # fp32 FLOP/s, H100 SXM5, no tensor cores
HBM_BW = 3.35e12             # bytes/s, H100 SXM5 HBM3
