"""Mixture-of-Experts FFN layer (port of ``src/repro/models/moe.py``).

Dispatch/combine use the gather/scatter form of the JIT-planned SpMM
(``core.moe_spmm``): the routing matrix S is applied as Sᵀ·tokens /
S·expert_out, the model-stack realization of the paper's technique
(DESIGN.md §4.4); the tests and ``chip_smoke.py`` hold it to the
concrete-routing SpMM path on identical routings.

Routing is grouped per batch row (the standard local dispatch group),
as the reference's ``vmap`` over rows: the batch dimension is written
out, and each row's routing is the reference's for that row.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import moe_spmm
from .layers import rms_norm


def moe_capacity(seq: int, top_k: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    return max(top_k, int(capacity_factor * seq * top_k / num_experts))


def moe_ffn(p: Dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, norm_eps: float = 1e-5
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm MoE SwiGLU FFN: x + combine(experts(dispatch(norm(x)))).

    p: router (D,E), w_gate/w_up (E,D,F), w_down (E,F,D), ln (D,)
    x: (B, S, D), one data group's rows on a mesh (its weights gathered
    by the stack).  Returns (out, aux_losses).  The reference's
    ``shard_ctx`` hints here (``_c``, its XLA-only ``moe_shard`` variant
    pinning the dispatch buffers to the batch axes) have no eager
    counterpart: the buffers are the group's own.
    """
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], norm_eps)
    logits = torch.einsum("bsd,de->bse", h.float(), p["router"].float())
    C = moe_capacity(S, top_k, num_experts, capacity_factor)

    routes = [moe_spmm.topk_routing(logits[b], top_k, C) for b in range(B)]
    gates, expert_ids, slots = (torch.stack(t) for t in zip(*routes))
    # renormalize gates over the chosen k (mixtral-style)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)

    xe = torch.stack([moe_spmm.dispatch(h[b], expert_ids[b], slots[b],
                                        num_experts, C)
                      for b in range(B)])                  # (B,E,C,D)
    g = torch.einsum("becd,edf->becf", xe, p["w_gate"].to(xe.dtype))
    u = torch.einsum("becd,edf->becf", xe, p["w_up"].to(xe.dtype))
    act = torch.nn.functional.silu(g.float()).to(xe.dtype) * u
    del g, u
    oe = torch.einsum("becf,efd->becd", act, p["w_down"].to(xe.dtype))
    out = torch.stack([moe_spmm.combine(oe[b], gates[b].to(oe.dtype),
                                        expert_ids[b], slots[b])
                       for b in range(B)])                 # (B,S,D)

    # aux losses: switch load-balance + router z-loss
    probs = torch.softmax(logits, dim=-1)                  # (B,S,E)
    me = torch.mean(probs, dim=(0, 1))                     # (E,)
    top1 = torch.nn.functional.one_hot(torch.argmax(logits, -1),
                                       num_experts).float()
    ce = torch.mean(top1, dim=(0, 1))
    aux = {"moe_lb_loss": num_experts * torch.sum(me * ce),
           "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return x + out.to(x.dtype), aux
