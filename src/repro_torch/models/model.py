"""Model facade: config -> init / loss / serve entry points + input specs
(port of ``src/repro/models/model.py``).  Under ``shard_ctx`` the loss
is a vocabulary-parallel cross-entropy over the model chips' logit
shards.

Every entry point runs on the card unless the caller passes
``device="cpu"``.  ``param_shapes`` and ``input_specs`` return tensors
on the ``meta`` device, the counterpart of ``jax.eval_shape`` and
``ShapeDtypeStruct``: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..distributed import collectives
from . import transformer


def _mean_nll(nll, mask=None):
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def cross_entropy_loss(logits, labels, mask=None):
    """logits (B,S,V) f32, labels (B,S) integer. Mean NLL over tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _mean_nll(logz - gold, mask)


def vocab_parallel_cross_entropy(shards, starts, labels, mask=None, *,
                                 device):
    """:func:`cross_entropy_loss` over logits split by vocabulary across
    the model chips (shard ``m``: columns ``starts[m]`` on, on its
    chip), the reference's ``("DP", None, "model")`` logits: the row
    max over the chips, the chips' sums of exponentials, and the label's
    logit from the chip that holds it, reduced on ``device``; the
    shards are never assembled."""
    if len(shards) == 1:
        return cross_entropy_loss(shards[0], labels.to(shards[0].device),
                                  None if mask is None
                                  else mask.to(shards[0].device))
    top = collectives.vocab_max(shards, device)
    logz = top + torch.log(collectives.vocab_sumexp(shards, top, device))
    gold = collectives.vocab_target(shards, starts, labels, device)
    return _mean_nll(logz - gold, None if mask is None else mask.to(device))


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    # -- params ----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, *,
             device=None) -> Dict[str, Any]:
        return transformer.init_params(self.cfg, generator, device=device)

    def param_shapes(self) -> Any:
        return transformer.init_params(self.cfg, device="meta")

    # -- training --------------------------------------------------------
    def loss_fn(self, params, batch, *, remat: str = "full",
                chunk_q: int = 512, shard_ctx=None, causal_skip: bool = False,
                backend: str = "auto", staging: Optional[str] = None,
                device=None):
        shards, starts, aux = transformer.forward_train_parts(
            self.cfg, params, batch["tokens"],
            image_embeds=batch.get("image_embeds"), remat=remat,
            chunk_q=chunk_q, shard_ctx=shard_ctx,
            causal_skip=causal_skip, backend=backend, staging=staging,
            device=device)
        loss = vocab_parallel_cross_entropy(
            shards, starts, batch["labels"], batch.get("loss_mask"),
            device=aux["moe_aux"].device)
        total = loss + 1e-2 * aux["moe_aux"]
        return total, {"nll": loss, **aux}

    # -- serving ---------------------------------------------------------
    def prefill(self, params, tokens, cache_len: int, image_embeds=None,
                **fwd_opts):
        return transformer.prefill(self.cfg, params, tokens, cache_len,
                                   image_embeds=image_embeds, **fwd_opts)

    def decode_step(self, params, token, caches, pos, *, shard_ctx=None,
                    device=None):
        return transformer.forward_decode(self.cfg, params, token, caches,
                                          pos, shard_ctx=shard_ctx,
                                          device=device)

    def init_cache(self, batch: int, cache_len: int, *, device=None):
        return transformer.init_decode_cache(self.cfg, batch, cache_len,
                                             device=device)

    # -- dry-run input specs ----------------------------------------------
    def input_specs(self, shape: ShapeSpec, *, per_pod_batch: Optional[int]
                    = None) -> Dict[str, Any]:
        """``meta`` tensors standing in for every model input of this cell
        (no allocation).  Modality frontends are stubs per task spec:
        the VLM's image embeddings arrive as precomputed (B, I, D)."""
        cfg = self.cfg
        B = per_pod_batch if per_pod_batch is not None else shape.global_batch
        dt = getattr(torch, cfg.dtype)

        def f(shape_, dtype):
            return torch.empty(shape_, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            specs = {"tokens": f((B, shape.seq_len), torch.int32)}
            if shape.kind == "train":
                specs["labels"] = f((B, shape.seq_len), torch.int32)
            if cfg.family == "vlm":
                specs["image_embeds"] = f(
                    (B, cfg.num_image_tokens, cfg.d_model), dt)
            return specs
        if shape.kind == "decode":
            return {
                "token": f((B, 1), torch.int32),
                "caches": transformer.init_decode_cache(
                    cfg, B, shape.seq_len, device="meta"),
                "pos": f((), torch.int32),
            }
        raise ValueError(shape.kind)
