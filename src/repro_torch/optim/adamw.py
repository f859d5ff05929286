"""AdamW with float32 moments, global-norm clipping and a warmup+cosine
schedule (port of ``src/repro/optim/adamw.py``).

Updates run under ``torch.no_grad()`` on the parameters' devices.  Trees
are nested dicts of tensors; the global gradient norm sums the leaves'
squared sums in the reference's leaf order (``pytree.tree_leaves``:
sorted keys), so the two packages add them in the same order.  Leaves
may lie on several cards (a mesh's blocks): the squares move to the
first leaf's device in one copy a card and add there in leaf order, and
the scale, bias corrections and learning rate are copied once to each
card, so the arithmetic is one card's.
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
        # a fill on the device: a host scalar copied there would wait
        return torch.full((), self.learning_rate, dtype=torch.float32,
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
        leaves = tree_leaves(grads)
        devices = tuple(dict.fromkeys(g.device for g in leaves))
        if self.clip_norm is not None:
            # each card's squares stacked and moved to the first leaf's
            # device in one copy, then added there in leaf order
            squares = [torch.sum(torch.square(g)) for g in leaves]
            moved = {d: iter(torch.stack([s for s in squares
                                          if s.device == d])
                             .to(devices[0]).unbind()) for d in devices}
            total = 0
            for s in squares:
                total = total + next(moved[s.device])
            gnorm = torch.sqrt(total)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            scales = {d: scale.to(d) for d in devices}
            grads = tree_map(lambda g: g * scales[g.device], grads)
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
        # bc1, bc2 and lr once on each leaf's device
        per = {d: (bc1.to(d), bc2.to(d), lr.to(d)) for d in devices}

        def upd(m, v, p):
            bc1_, bc2_, lr_ = per[m.device]
            step = (m / bc1_) / (torch.sqrt(v / bc2_) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.float()
            return (-lr_ * step).to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(count=count, mu=mu, nu=nu), gnorm

    @staticmethod
    @torch.no_grad()
    def apply_updates(params, updates):
        return tree_map(lambda p, u: p + u, params, updates)
