"""int8 gradient compression with error feedback (port of
``src/repro/optim/compression.py``).

Each gradient leaf is quantised to int8 with a per-leaf scale (max |g| /
127) and dequantised; the quantisation residual is kept and added back
into the next step's gradient (error feedback), so the accumulated error
stays bounded.  In a data-parallel step the int8 tensor is what a
gradient all-reduce would carry; on one card the pair brackets nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..pytree import tree_leaves, tree_map, tree_unflatten


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(g: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (g_hat, residual): g_hat is what the wire carries."""
    q, scale = _quantize(g.float())
    g_hat = _dequantize(q, scale)
    return g_hat, g.float() - g_hat


def make_error_feedback_transform():
    """Stateful grad transform: ``init(params)`` -> the zero residual
    tree; ``apply(grads, ef_state)`` -> (compressed grads, new
    ef_state)."""

    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @torch.no_grad()
    def apply(grads, ef_state):
        pairs = [compress_decompress(g.float() + e)
                 for g, e in zip(tree_leaves(grads), tree_leaves(ef_state))]
        return (tree_unflatten(grads, [p[0] for p in pairs]),
                tree_unflatten(ef_state, [p[1] for p in pairs]))

    return init, apply
