"""Mixture-of-Experts FFN layer (port of ``src/repro/models/moe.py``).

Dispatch/combine use the gather/scatter form of the JIT-planned SpMM
(``core.moe_spmm``): the routing matrix S is applied as Sᵀ·tokens /
S·expert_out, the model-stack realization of the paper's technique
(DESIGN.md §4.4); the tests and ``chip_smoke.py`` hold it to the
concrete-routing SpMM path on identical routings.

Routing is grouped per batch row (the standard local dispatch group),
as the reference's ``vmap`` over rows: the batch dimension is written
out, and each row's routing is the reference's for that row.

Under a model split (``distributed.model_split``) the routing is
computed once, as it is replicated, and the experts split over the
model chips where the rules split ``E`` (expert parallelism: a chip
dispatches to and computes only its experts, and its ``combine`` gives
a partial output); otherwise each chip computes every expert on its
``d_ff`` columns.  The chips' partials add on the group's device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core import moe_spmm
from ..distributed import sharding
from ..distributed.model_split import ModelSplit
from .layers import rms_norm


def moe_capacity(seq: int, top_k: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    return max(top_k, int(capacity_factor * seq * top_k / num_experts))


def _mine(expert_ids, slots, lo: int, hi: int, capacity: int):
    """The routing as a chip holding experts ``lo .. hi - 1`` sees it:
    its experts renumbered from 0, every other assignment sent to the
    scratch slot (dropped by ``dispatch``, zero in ``combine``)."""
    mine = (expert_ids >= lo) & (expert_ids < hi)
    return (torch.where(mine, expert_ids - lo, 0),
            torch.where(mine, slots, capacity))


def moe_ffn(p: Dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, norm_eps: float = 1e-5,
            split: Optional[ModelSplit] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pre-norm MoE SwiGLU FFN: x + combine(experts(dispatch(norm(x)))).

    p: router (D,E), w_gate/w_up (E,D,F), w_down (E,F,D), ln (D,)
    x: (B, S, D), one data group's rows on a mesh.  Returns (out,
    aux_losses).  ``split``: the model chips, by experts or by ``d_ff``.
    The reference's ``shard_ctx`` hints here (``_c``, its XLA-only
    ``moe_shard`` variant pinning the dispatch buffers to the batch
    axes) have no eager counterpart: the buffers are the group's own.
    """
    split = split or ModelSplit(x.device)
    B, S, D = x.shape
    h = rms_norm(x, split.take(p["ln"]), norm_eps)
    logits = torch.einsum("bsd,de->bse", h.float(),
                          split.take(p["router"]).float())
    C = moe_capacity(S, top_k, num_experts, capacity_factor)

    routes = [moe_spmm.topk_routing(logits[b], top_k, C) for b in range(B)]
    gates, expert_ids, slots = (torch.stack(t) for t in zip(*routes))
    # renormalize gates over the chosen k (mixtral-style)
    gates = gates / torch.clamp(torch.sum(gates, -1, keepdim=True), min=1e-9)

    w = p["w_gate"]
    by_expert = sharding.is_sharded(w) and \
        sharding.model_dim(w.placement, w.ndim) == 0
    chips = split.chips_for(w, 0 if by_expert else 2)

    def take(m):
        ids, sl, E = expert_ids, slots, num_experts
        if by_expert:
            lo, hi = split.owned(w, 0, m)
            if (lo, hi) != (0, num_experts):
                ids, sl, E = *_mine(ids, sl, lo, hi, C), hi - lo
            ws = tuple(split.take(p[n], m, 0, [(lo, hi)])
                       for n in ("w_gate", "w_up", "w_down"))
        else:
            cols = [split.owned(w, 2, m)]
            ws = (split.take(p["w_gate"], m, 2, cols),
                  split.take(p["w_up"], m, 2, cols),
                  split.take(p["w_down"], m, 1, cols))
        return (E, split.to(h, m), split.to(ids, m), split.to(sl, m),
                split.to(gates, m), *ws)

    def part(m, E, hm, ids, sl, gm, w_gate, w_up, w_down):
        xe = torch.stack([moe_spmm.dispatch(hm[b], ids[b], sl[b], E, C)
                          for b in range(B)])              # (B,E,C,D)
        g = torch.einsum("becd,edf->becf", xe, w_gate.to(xe.dtype))
        u = torch.einsum("becd,edf->becf", xe, w_up.to(xe.dtype))
        act = torch.nn.functional.silu(g.float()).to(xe.dtype) * u
        del g, u
        oe = torch.einsum("becf,efd->becd", act, w_down.to(xe.dtype))
        gm = gm.to(oe.dtype)
        return torch.stack([moe_spmm.combine(oe[b], gm[b], ids[b], sl[b])
                            for b in range(B)])            # (B,S,D)

    out = split.sum(split.run(chips, take, part))

    # aux losses: switch load-balance + router z-loss
    probs = torch.softmax(logits, dim=-1)                  # (B,S,E)
    me = torch.mean(probs, dim=(0, 1))                     # (E,)
    top1 = torch.nn.functional.one_hot(torch.argmax(logits, -1),
                                       num_experts).float()
    ce = torch.mean(top1, dim=(0, 1))
    aux = {"moe_lb_loss": num_experts * torch.sum(me * ce),
           "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2)}
    return x + out.to(x.dtype), aux
