"""Per-forward device-memory traffic of one fused SpMM launch — the
autotuner's memory term (port of ``spmm_hbm_traffic`` from
``src/repro/analysis/memmodel.py``, copied).

The reference's ``hbm_traffic`` and ``memory_seconds`` take a language
model's configuration and shape; they wait for the port's model stacks.
"""
from __future__ import annotations

from typing import Dict

F32 = 4


def spmm_hbm_traffic(*, slots: int, cols_entries: int, padded_nnz: int,
                     ws_rows: int, d_pad: int,
                     itemsize: int = F32) -> Dict[str, float]:
    """Per-forward device-memory bytes of one fused SpMM dispatch, from
    the packed workspace's own counts — the memory term
    ``core.autotune`` ranks candidate plans with (only streams that
    actually cross device memory).

      vals_stream  the flat slot buffer, read once per d-tile sweep
      cols_stream  the descriptor column stream (int32)
      x_gather     one (1, d_pad) X row (VPU) or (bk, d_pad)-panel slice
                   amortized per slot — padded_nnz gathers of d_pad lanes
      y_write      the workspace output rows, written once
    """
    return {
        "vals_stream": float(slots) * itemsize,
        "cols_stream": float(cols_entries) * 4,
        "x_gather": float(padded_nnz) * d_pad * itemsize,
        "y_write": float(ws_rows) * d_pad * itemsize,
    }
