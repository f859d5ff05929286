"""MoE dispatch/combine expressed as JIT-planned SpMM (port of
``src/repro/core/moe_spmm.py``).

The routing matrix ``S`` (tokens x experts*capacity) is CSR-sparse with
at most top_k nonzeros per row (the gates):

    dispatch:  X_e = Sᵀ · tokens        (E*C, D) -> reshape (E, C, D)
    combine:   Y   = S  · expert_out

Expert-capacity imbalance is precisely the paper's row-imbalance
problem, and the nnz_split planner is its capacity-balancing fix.

Two regimes, as in the reference (DESIGN.md §4.4):

  * concrete routing (serving / offline): the CSR is built on the host
    and planned, and both products run through ``compile_spmm`` — on the
    card's ``backend="auto"`` that is K4 (``spmm_bcsr_fused_staged``),
    two launches a call (``routing_to_csr`` + ``moe_apply_concrete``);
  * inside the model stack: the same math as index gather/scatter
    (``dispatch`` / ``combine``), the ``ref`` backend evaluated with the
    routing as data.  Every kept slot holds exactly one token, so
    ``dispatch`` equals Sᵀ·tokens bit for bit; only the scratch row
    ``capacity``, which is discarded, sums several.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSRMatrix


# ---------------------------------------------------------------------------
# In-model (dynamic-structure) path
# ---------------------------------------------------------------------------

def topk_routing(router_logits: torch.Tensor, top_k: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with per-expert capacity.

    Returns (gates (T,k), expert_ids (T,k), slot_ids (T,k)); tokens over
    capacity get slot == capacity (dropped: the scratch row, the
    standard capacity-factor semantics).  A token's slot is its rank
    among the (token, k) assignments to the same expert in token-major
    order, so overflow drops the latest tokens, deterministically.
    """
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gates, expert_ids = torch.topk(probs, top_k, dim=-1)      # (T, k)
    flat = torch.nn.functional.one_hot(expert_ids.reshape(-1), E)  # (T*k, E)
    pos = torch.cumsum(flat, dim=0) - flat
    slot = torch.sum(flat * pos, dim=-1).reshape(T, top_k)
    slot = torch.clamp(slot, max=capacity)                     # overflow
    return gates, expert_ids, slot


def dispatch(tokens: torch.Tensor, expert_ids: torch.Tensor,
             slot_ids: torch.Tensor, num_experts: int,
             capacity: int) -> torch.Tensor:
    """X_e = Sᵀ·tokens by scatter-add (``index_add_``, the reference's
    ``.at[].add``): tokens (T, D) -> (E, C, D); dropped tokens land in
    the scratch slot, which is cut off."""
    T, D = tokens.shape
    k = expert_ids.shape[1]
    flat_rows = (expert_ids * (capacity + 1) + slot_ids).reshape(-1)
    buf = tokens.new_zeros((num_experts * (capacity + 1), D))
    buf.index_add_(0, flat_rows, tokens.repeat_interleave(k, dim=0))
    return buf.reshape(num_experts, capacity + 1, D)[:, :capacity]


def combine(expert_out: torch.Tensor, gates: torch.Tensor,
            expert_ids: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Y = S·expert_out by gather (the ``ref`` backend's semantics)."""
    E, C, D = expert_out.shape
    T, k = gates.shape
    flat = torch.cat([expert_out, expert_out.new_zeros((E, 1, D))],
                     dim=1).reshape(E * (C + 1), D)
    idx = (expert_ids * (C + 1) + slot_ids).reshape(-1)       # (T*k,)
    picked = flat[idx].reshape(T, k, D)
    return torch.sum(gates[..., None].to(picked.dtype) * picked, dim=1)


# ---------------------------------------------------------------------------
# Concrete-routing (host/JIT-planned) path — the paper's pipeline
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def routing_to_csr(gates, expert_ids, slot_ids, num_experts: int,
                   capacity: int, *, device=None) -> CSRMatrix:
    """Materialize S (T x E*C) as CSR from a concrete routing decision.

    The structure is built on the host (numpy), the values become a
    float32 tensor on ``device`` (the card unless ``"cpu"``).  Dropped
    tokens (slot == capacity) are omitted — their row has fewer
    nonzeros, the skewed-row case the planners handle.
    """
    from ..kernels.ops import resolve_device
    g = _host(gates).astype(np.float32)
    e = _host(expert_ids)
    s = _host(slot_ids)
    T, k = g.shape
    keep = (s < capacity).reshape(-1)
    rows = np.repeat(np.arange(T), k)[keep]
    cols = (e * capacity + s).reshape(-1)[keep].astype(np.int32)
    vals = g.reshape(-1)[keep]
    order = np.lexsort((cols, rows))
    row_ptr = np.zeros(T + 1, dtype=np.int64)
    np.add.at(row_ptr[1:], rows, 1)
    np.cumsum(row_ptr, out=row_ptr)
    return CSRMatrix(shape=(T, num_experts * capacity), row_ptr=row_ptr,
                     col_indices=cols[order],
                     vals=torch.from_numpy(vals[order]).to(
                         resolve_device(device)))


def moe_apply_concrete(tokens, router_logits, w_up, w_down, *, top_k: int,
                       capacity: int, strategy: str = "nnz_split",
                       backend: str = "ref", device: Optional[str] = None,
                       **spmm_knobs):
    """Full MoE layer on a concrete routing via JIT-planned SpMM:
    combine(S, silu(dispatch(Sᵀ, tokens) @ W_up) @ W_down).

    w_up (E, D, F), w_down (E, F, D).  ``backend`` keeps the reference's
    default ``"ref"``; ``"auto"`` is ``pallas_bcsr`` on the card, whose
    default staging runs both products on K4.  ``device`` is resolved as
    for every entry point; ``spmm_knobs`` pass through to ``spmm``
    (``staging``, ``bm``, ``cache``, ...).  The oracle the in-model
    gather path is tested against.
    """
    from ..kernels.ops import resolve_device
    from .spmm import spmm
    device = resolve_device(device)
    E = w_up.shape[0]
    gates, expert_ids, slot = topk_routing(router_logits, top_k, capacity)
    s_csr = routing_to_csr(gates, expert_ids, slot, E, capacity,
                           device=device)
    # dispatch uses unit values (gates apply once, at combine)
    s_ones = CSRMatrix(s_csr.shape, s_csr.row_ptr, s_csr.col_indices,
                       torch.ones(s_csr.nnz, device=device))
    st, _ = s_ones.transpose_structure()
    xe = spmm(st, tokens.float(), strategy=strategy, backend=backend,
              device=device, **spmm_knobs)                    # (E*C, D)
    xe = xe.reshape(E, capacity, -1)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe,
                                              w_up.float()))
    out_e = torch.einsum("ecf,efd->ecd", h, w_down.float())
    return spmm(s_csr, out_e.reshape(E * capacity, -1), strategy=strategy,
                backend=backend, device=device, **spmm_knobs)  # (T, D)
