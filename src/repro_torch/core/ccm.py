"""Coarse-grain column merging (CCM) — paper §IV-C/§IV-D, adapted to TPU.

The paper's CCM unrolls the column loop (``for j in 0..d``) because ``d``
is known at codegen time, keeps the whole output row ``ret[0:d]`` in SIMD
registers, and decomposes ``d`` into register-class tiles
(d=45 → ZMM(16)+ZMM(16)+YMM(8)+XMM(4)+scalar(1)).

On TPU the register classes don't exist; the vector unit operates on
(8 sublanes x 128 lanes) VREG tiles and sub-128 slices are expressed by
*masking*, not smaller registers.  The adaptation (DESIGN.md §7.3):

  * ``ccm_register_decomposition(d)`` reproduces the paper's exact x86
    decomposition — used by the profiling benchmark to count the
    "instructions" the paper's codegen would emit, and to document the
    mapping.
  * ``plan_d_tiles(d, ...)`` is the TPU planner: pick a lane-tile width
    ``dt`` (multiple of 128, capped by the VMEM accumulator budget),
    pad ``d`` up to ``d_pad = ceil(d/dt)*dt``, and mask the remainder.
    The accumulator tile (rows_in_flight x dt) stays resident in
    VMEM/VREGs across the whole nnz loop — the register-retention that
    gives the paper its 2.4-2.7x memory-load reduction.

Port of ``src/repro/core/ccm.py`` with the same constants, so the port
pads ``d`` exactly as the reference does and its workspaces match; only
``pad_cols`` changes, to torch.  On the GPU the same ``d_pad`` is cut
into 128-column CTA tiles, one output column per thread, and the
per-row accumulators live in registers (``kernels/csrc``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

LANE = 128          # TPU lane count (minor-most tile dim)
SUBLANE = 8         # f32 sublane count
VMEM_BYTES = 128 * 1024  # conservative per-core working-set budget for acc


# -- the paper's x86 decomposition (documentation + profiling model) -------
_X86_CLASSES = (("zmm", 16), ("ymm", 8), ("xmm", 4), ("scalar", 1))


def ccm_register_decomposition(d: int) -> List[Tuple[str, int]]:
    """Decompose d into (register_class, width) tiles exactly as the
    paper's codegen does (fewest registers, greedy by size).

    >>> ccm_register_decomposition(45)
    [('zmm', 16), ('zmm', 16), ('ymm', 8), ('xmm', 4), ('scalar', 1)]
    """
    out: List[Tuple[str, int]] = []
    rem = d
    for name, width in _X86_CLASSES:
        while rem >= width:
            out.append((name, width))
            rem -= width
    assert rem == 0
    return out


def x86_instruction_estimate(d: int, nnz: int, m: int) -> dict:
    """Instruction-count model of the paper's generated code (Listing 2):
    per nonzero: 1 broadcast + one FMA per register tile; per row:
    zeroing + stores per tile + 2 row_ptr loads.  Used by
    benchmarks/bench_profile_counts.py to compare against AOT models."""
    tiles = len(ccm_register_decomposition(d))
    per_nnz = 1 + 1 + tiles          # col load + broadcast + FMAs
    per_row = 2 + 2 * tiles + 2      # ptr loads, zero+store per tile, loop ctl
    return {
        "tiles": tiles,
        "instructions": per_nnz * nnz + per_row * m,
        "memory_loads": nnz * (1 + 1 + tiles) + 2 * m,  # col, val, X-tiles
        "branches": nnz + m,          # one backedge per nnz-loop iteration
    }


# -- the TPU lane-tile planner ---------------------------------------------
@dataclasses.dataclass(frozen=True)
class DTiling:
    d: int            # logical columns
    d_pad: int        # padded columns (multiple of dt)
    dt: int           # lane-tile width (multiple of LANE)
    num_tiles: int    # d_pad // dt
    mask_width: int   # valid lanes in the last tile (== dt if exact)

    @property
    def padding_waste(self) -> float:
        return 1.0 - self.d / self.d_pad


def plan_d_tiles(d: int, *, rows_in_flight: int = 1, bytes_per_el: int = 4,
                 max_dt: int = 512, vmem_budget: int = VMEM_BYTES) -> DTiling:
    """Choose the lane-tile width for the accumulator.

    Mirrors the paper's "fewest registers" objective: the widest tile
    that (a) is a multiple of 128 lanes, (b) keeps the accumulator
    (rows_in_flight x dt) plus one staged X row inside the VMEM budget,
    and (c) does not overshoot d by more than one tile.
    """
    if d <= 0:
        raise ValueError("d must be positive")
    budget_lanes = vmem_budget // ((rows_in_flight + 1) * bytes_per_el)
    dt = min(max_dt, max(LANE, (budget_lanes // LANE) * LANE))
    # don't pick a tile wider than the padded d itself
    d_ceil = -(-d // LANE) * LANE
    dt = min(dt, d_ceil)
    d_pad = -(-d // dt) * dt
    num = d_pad // dt
    rem = d - (num - 1) * dt
    return DTiling(d=d, d_pad=d_pad, dt=dt, num_tiles=num,
                   mask_width=rem if rem > 0 else dt)


def kernel_lane_tile(d_pad: int, max_dt: int = 512) -> int:
    """Lane-tile width a kernel uses for an already-padded d_pad: the
    widest power-of-two-halving of max_dt that divides d_pad.  Agrees
    with ``plan_d_tiles`` on planner-padded inputs (d_pad is a multiple
    of dt there by construction) and degrades gracefully on direct
    kernel calls with unplanned widths.  One definition, shared by the
    Pallas kernels, so a CCM tiling-policy change lands everywhere."""
    dt = min(d_pad, max_dt)
    while d_pad % dt:
        dt //= 2
    return dt


def pad_cols(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    """Pad the dense operand X (n, d) to (n, d_pad) with zero columns —
    the masked remainder tile of DESIGN.md §7.3."""
    n, d = x.shape
    if d == d_pad:
        return x
    return torch.nn.functional.pad(x, (0, d_pad - d))
