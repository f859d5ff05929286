"""Training and serving step builders (port of
``src/repro/train/train_step.py``).

Gradients come from ``torch.autograd`` on ``Model.loss_fn``.  With
``microbatches`` > 1 the batch is split along its leading axis and the
float32 gradients accumulate over a loop of the microbatches (the
reference's ``lax.scan``); the loss is their mean and ``nll`` the last
microbatch's, as in the reference.  The step returns new parameter and
optimizer-state trees, as the reference's functional step does.

On a mesh (``shard_ctx``) the parameters and optimizer state are trees
of ``ShardedTensor`` s and each microbatch splits further into its data
groups (``data_groups``, the reference's ``_constrain`` of the batch),
enqueued in turn by one controller, every piece's rows moved to its
group's card first.  Each group runs its model chips
(``models/transformer.py``, the Megatron split of
``distributed/model_split.py``): every chip takes its inputs and
gathers over the data axis only its own part of each period's weights,
all chips' before the first chip's part, then computes its heads,
``d_ff`` columns, experts or channels, and the chips' partial sums add
on the group's device.  The groups' gradients are born on the
parameters' blocks, which is where the reference's reduce-scatter puts
them (its ``grad_shardings``): the step sums them in float32 over every
(microbatch, group) piece in order and divides by their count, the
arithmetic of ``microbatches * groups`` microbatches.  With one model
chip a group computes as the unsharded step does, so a (2, 1) mesh's
step is the unsharded ``microbatches=2`` step's loss bit for bit; with
more, the partial sums' order, and each chip's gradient of a taken
input added as one term, differ from the whole products' in the last
bits.  One piece takes its gradients as they come, with no float32
copy.  ``AdamW.update`` then runs on the blocks; its global grad norm
sums the blocks' squares, whose order differs from the whole leaves' in
the last bits.

The chips may lie on several cards (``launch.mesh.make_host_mesh(cards=
)``), any layout: each data group then computes on its first chip's
card, each model chip on its own.  A
tensor crosses cards by ``sharding.card_copy``, on a copy stream of
the source card for the pair of cards, so it waits for its own
producer, not behind the source card's queue: a data group's gathers
of the other group's blocks wait only for the step's start
(``sharding.written``), not for that group's forward and backward.  The
gradients a group sends back to the blocks it read on another group's
card still join that card's stream (their copies' barrier, their sums,
the step's ``acc + g``), so there the second group starts once the
first group's backward is done; a group's model chips compute at once.
The backward runs on the calling thread alone (no thread a card), every
card's nodes in the one order a single card runs them: later-made nodes
first, so every chip's part before any chip's take, whose gradient a
copy sends back to the group's card behind no part.  Every chip
reaches its inputs through a node of its own (a copy across cards, a
view on one card), so each chip's gradient of an input adds as one
term in the same order whichever chips lie off the group's card: the
step over any number of cards is the one-card mesh's bit for bit
(``tests/test_torch_cards.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..distributed.sharding import (LogicalMesh, card_copy, gather,
                                    is_sharded, written)
from ..kernels.ops import resolve_device
from ..models.model import Model
from ..optim.adamw import AdamW, AdamWState
from ..pytree import (tree_leaves, tree_map, tree_map_with_path,
                      tree_unflatten)


def _on(device, batch):
    """The batch's arrays (numpy, tensors, or tensors placed by
    ``batch_shardings``) as tensors on ``device``."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if is_sharded(x):
            return gather(x, device)
        return x.to(device)
    return {name: move(x) for name, x in batch.items()}


def data_groups(shard_ctx, batch: int,
                device) -> List[Tuple[int, Any, slice]]:
    """(group, device, rows) of each data group of a ``batch``-row
    batch: the counterpart of the reference's ``_constrain(x, shard_ctx,
    ("DP", ...))`` of the batch.  With ``n`` = the product of the ``dp``
    axes dividing ``batch``, group ``g`` takes rows ``g*B/n ..
    (g+1)*B/n`` on the device of its first chip (the lowest chip whose
    ``dp`` coordinates, row-major, are ``g``); otherwise (and with no
    ``shard_ctx``) one group, 0, all rows, on ``device``: the reference
    leaves a dim that does not divide unconstrained, so every data chip
    computes the whole batch, which the port computes once.  Each group
    computes on its own model chips (``shard_ctx["group"]``)."""
    if shard_ctx is None:
        return [(0, device, slice(0, batch))]
    mesh, dp = shard_ctx["mesh"], tuple(shard_ctx["dp"])
    sizes = mesh.sizes
    n = math.prod(sizes[a] for a in dp)
    if n == 1 or batch % n or batch == 0:
        return [(0, device, slice(0, batch))]
    owner: Dict[int, Any] = {}
    for chip in range(mesh.size):
        at = mesh.coords(chip)
        g = 0
        for a in dp:
            g = g * sizes[a] + at[a]
        owner.setdefault(g, mesh.devices[chip])
    size = batch // n
    return [(g, str(owner[g]), slice(g * size, (g + 1) * size))
            for g in range(n)]


def _pieces(batch, microbatches: int, shard_ctx, device):
    """(group, device, rows) of every (microbatch, data group) piece of
    the batch, microbatch-major."""
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into "
                         f"{microbatches} microbatches")
    size = B // microbatches
    out = []
    for i in range(microbatches):
        base = i * size
        out += [(g, dev, slice(base + rows.start, base + rows.stop))
                for g, dev, rows in data_groups(shard_ctx, size, device)]
    return out


def _check_placements(params, placements) -> None:
    """``grad_shardings`` must name the parameters' own placements: the
    gradients are born on the parameters' blocks."""
    def leaf(path, p, want):
        have = p.placement if is_sharded(p) else None
        if have != want:
            raise ValueError(f"grad_shardings{path}: gradients are born on "
                             f"the parameter's placement {have}, not "
                             f"{want}")
        return p
    tree_map_with_path(leaf, params, placements, is_leaf=is_sharded)


def make_train_step(model: Model, optimizer: AdamW, *, remat: str = "full",
                    microbatches: int = 1, chunk_q: int = 512,
                    shard_ctx=None, causal_skip: bool = False,
                    grad_shardings=None, grad_transform=None, device=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) on ``device`` (the card unless ``"cpu"``; on a mesh, the
    data groups' devices), metrics ``loss``, ``grad_norm`` and ``nll``
    as float32 tensors.  ``shard_ctx = {"mesh", "dp"}`` (and optionally
    a ``"tally"``, ``model_split.SplitTally``) takes sharded parameter
    and optimizer-state trees; ``grad_shardings`` (a tree of
    placements, on a mesh only), the reference's reduce-scatter target,
    is checked to be the parameters' placements, where the gradients
    already are.  ``grad_transform`` (optional) maps the gradient tree
    before the optimizer, e.g. a closure over ``optim.compression``'s
    error-feedback transform."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    if shard_ctx is not None:
        mesh = shard_ctx["mesh"]
        if not isinstance(mesh, LogicalMesh):
            raise TypeError(f"shard_ctx['mesh'] must be a LogicalMesh, got "
                            f"{type(mesh).__name__}")
        types = {d.type for d in mesh.devices}
        if len(types) > 1 or "meta" in types:
            raise ValueError(f"the sharded step computes on its chips' "
                             f"devices: a mesh on {sorted(types)} mixes "
                             f"device types or holds shapes only")
        device = str(mesh.devices[0])
    elif grad_shardings is not None:
        raise ValueError("grad_shardings places gradients on a mesh: it "
                         "needs shard_ctx")
    else:
        device = resolve_device(device)
    def value_and_grad(params, batch, group, dev, ready=None):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        ctx = None if shard_ctx is None else {**shard_ctx, "group": group,
                                              "ready": ready}
        # the backward on this thread alone: autograd otherwise runs a
        # thread a card, and a tensor whose gradient sums parts from two
        # cards would add them in the order they arrive
        with torch.enable_grad(), \
                torch.autograd.set_multithreading_enabled(False):
            loss, aux = model.loss_fn(
                tree_unflatten(params, leaves), batch, remat=remat,
                chunk_q=chunk_q, shard_ctx=ctx,
                causal_skip=causal_skip, device=dev)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            tree_unflatten(params, grads)

    def compute_grads(params, batch):
        pieces = _pieces(batch, microbatches, shard_ctx, device)
        # the blocks and the batch are written: a data group's copies
        # from another group's card wait for this, not for that group
        ready = None if shard_ctx is None else written(mesh.devices)
        if len(pieces) == 1:
            return value_and_grad(params, batch, *pieces[0][:2], ready)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_sum, nlls = 0.0, []
        # every piece's rows on its group's card before the first piece
        # computes
        moved = [{k: card_copy(v[rows], dev) for k, v in batch.items()}
                 for _, dev, rows in pieces]
        for (group, dev, _), piece in zip(pieces, moved):
            loss, aux, grads = value_and_grad(params, piece, group, dev,
                                              ready)
            acc = tree_map(lambda a, g: a + g.float(), acc, grads)
            loss_sum = loss_sum + card_copy(loss, device)
            nlls.append(card_copy(aux["nll"], device))
        # nll: the last microbatch's, over its data groups
        per = len(pieces) // microbatches
        aux = {"nll": sum(nlls[-per:]) / per}
        grads = tree_map(lambda g: g / len(pieces), acc)
        return loss_sum / len(pieces), aux, grads

    def train_step(params, opt_state: AdamWState, batch):
        loss, aux, grads = compute_grads(params, _on(device, batch))
        if grad_shardings is not None:
            _check_placements(params, grad_shardings)
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
