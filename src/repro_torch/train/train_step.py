"""Training and serving step builders (port of
``src/repro/train/train_step.py``).

Gradients come from ``torch.autograd`` on ``Model.loss_fn``.  With
``microbatches`` > 1 the batch is split along its leading axis and the
float32 gradients accumulate over a loop of the microbatches (the
reference's ``lax.scan``); the loss is their mean and ``nll`` the last
microbatch's, as in the reference.  The step returns new parameter and
optimizer-state trees, as the reference's functional step does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import resolve_device
from ..models.model import Model
from ..optim.adamw import AdamW, AdamWState
from ..pytree import tree_leaves, tree_map, tree_unflatten


def _on(device, batch):
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)
    return {name: move(x) for name, x in batch.items()}


def make_train_step(model: Model, optimizer: AdamW, *, remat: str = "full",
                    microbatches: int = 1, chunk_q: int = 512,
                    shard_ctx=None, causal_skip: bool = False,
                    grad_shardings=None, grad_transform=None, device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on ``device`` (the card unless ``"cpu"``), metrics ``loss``,
    ``grad_norm`` and ``nll`` as float32 tensors.  ``grad_transform``
    (optional) maps the gradient tree before the optimizer, e.g. a
    closure over ``optim.compression``'s error-feedback transform.
    ``shard_ctx`` and ``grad_shardings`` raise: the sharding slice."""
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings: per-parameter gradient shardings wait for the "
            "port's sharding slice (distributed/sharding.py's param "
            "shardings); the port's train step runs on one card")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    device = resolve_device(device)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = model.loss_fn(
                tree_unflatten(params, leaves), batch, remat=remat,
                chunk_q=chunk_q, shard_ctx=shard_ctx,
                causal_skip=causal_skip, device=device)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            tree_unflatten(params, grads)

    def compute_grads(params, batch):
        if microbatches == 1:
            return value_and_grad(params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{microbatches} microbatches")
        size = B // microbatches
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum = 0.0
        for i in range(microbatches):
            mbatch = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, aux, grads = value_and_grad(params, mbatch)
            acc = tree_map(lambda a, g: a + g.float(), acc, grads)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / microbatches, acc)
        return loss_sum / microbatches, aux, grads

    def train_step(params, opt_state: AdamWState, batch):
        loss, aux, grads = compute_grads(params, _on(device, batch))
        if grad_transform is not None:
            grads = grad_transform(grads)
        updates, opt_state, gnorm = optimizer.update(grads, opt_state,
                                                     params)
        params = AdamW.apply_updates(params, updates)
        metrics = {"loss": loss.float(), "grad_norm": gnorm,
                   "nll": aux["nll"].float()}
        return params, opt_state, metrics

    return train_step


def make_serve_step(model: Model, *, shard_ctx=None, device=None):
    """decode serve_step(params, token, caches, pos) -> (logits, caches)
    — one new token against the caches (written in place)."""

    def serve_step(params, token, caches, pos):
        return model.decode_step(params, token, caches, pos,
                                 shard_ctx=shard_ctx, device=device)

    return serve_step


def make_prefill_step(model: Model, cache_len: int, **fwd_opts):
    def prefill_step(params, tokens, image_embeds=None):
        return model.prefill(params, tokens, cache_len,
                             image_embeds=image_embeds, **fwd_opts)
    return prefill_step
