"""AdamW with float32 moments, global-norm clipping and a warmup+cosine
schedule (port of ``src/repro/optim/adamw.py``).

Updates run under ``torch.no_grad()`` on the parameters' device.  Trees
are nested dicts of tensors; the global gradient norm sums the leaves'
squared sums in the reference's leaf order (``pytree.tree_leaves``:
sorted keys), so the two packages add them in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..pytree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    count: torch.Tensor       # () int32
    mu: Any                   # float32 tree like params
    nu: Any                   # float32 tree like params


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """step -> learning rate (a float32 tensor): linear warmup over
    ``warmup`` steps, then a cosine decay to ``min_frac`` of ``base_lr``
    at ``total``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable, float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """-> (updates like params, new state, the global grad norm
        before clipping, float32; 0 with ``clip_norm=None``)."""
        grads = tree_map(lambda g: g.float(), grads)
        if self.clip_norm is not None:
            total = 0
            for g in tree_leaves(grads):
                total = total + torch.sum(torch.square(g))
            gnorm = torch.sqrt(total)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        else:
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=state.count.device)
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        c = count.float()
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        lr = self._lr(count)

        def upd(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.float()
            return (-lr * step).to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(count=count, mu=mu, nu=nu), gnorm

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates):
        return tree_map(lambda p, u: p + u, params, updates)
