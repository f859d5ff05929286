"""The 2-layer graph convolution network of ``examples/gnn_graphconv.py``
on the port — the paper's own application (GNNs, §I).

The model is ``Â·relu(Â·(X·W1))·W2`` with both neighbourhood
aggregations ``Â·H`` run by compiled SpMM artifacts (one per width,
planned once and cached across steps) and the dense products left to
``torch.matmul``.  Parameters are a dict ``{"w1", "w2"}`` of leaf
tensors, the reference's pytree (``convert.params_from_numpy`` carries
one across).  Training differentiates the artifacts: with constant
``Â`` values each step runs two forward aggregations and two dX
aggregations through the transposed artifacts, and no dvals work.
"""
from __future__ import annotations

import torch


def gcn_forward(params, agg_h, agg_out, a_vals: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Logits ``Â·(relu(Â·(X·W1))·W2)``; ``agg_h``/``agg_out`` are the
    artifacts for widths ``W1.shape[1]`` and ``W2.shape[1]``."""
    h = torch.relu(agg_h(a_vals, x @ params["w1"]))
    return agg_out(a_vals, h @ params["w2"])


def gcn_loss(params, agg_h, agg_out, a_vals: torch.Tensor, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against integer ``labels``."""
    logits = gcn_forward(params, agg_h, agg_out, a_vals, x)
    return torch.nn.functional.cross_entropy(logits, labels)


def sgd_step(params, lr: float) -> None:
    """One plain SGD update in place, ``p -= lr * p.grad``, then clears
    the gradients."""
    with torch.no_grad():
        for p in params.values():
            p -= lr * p.grad
            p.grad = None
