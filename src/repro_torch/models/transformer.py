"""Unified decoder stack for all eleven architectures (port of
``src/repro/models/transformer.py``).

Depth is ``num_periods`` repetitions of the config's layer ``pattern``;
parameters are stacked over periods as the reference stacks them (each
leaf has a leading period axis), so a reference pytree carries across
leaf for leaf (``convert.model_params_from_numpy``).  The reference's
``lax.scan`` over periods is a Python loop over the period index here;
heterogeneous patterns (jamba's 7:1 mamba:attn, the VLM's 1-in-5
cross-attention) unroll within the period.  ``remat="full"``
checkpoints each period with ``torch.utils.checkpoint`` when grad is
on; ``"none"`` keeps every activation.

Slots: ``attn`` (dense GQA), ``sattn`` (the fused sparse-attention
sandwich in ``forward_train`` — K6 under the card's default lowering,
K5 with ``staging="resident"`` — and the reference's dense masked
fallback in ``prefill``/``forward_decode``), ``xattn`` (cross-attention
to image embeddings), and the recurrent ``mamba`` (``models/mamba.py``)
and ``rwkv`` (``models/rwkv6.py``, its channel-mix in place of an FFN);
FFNs dense SwiGLU or MoE.

``shard_ctx = {"mesh": LogicalMesh, "dp": batch axes}`` runs the stack
over parameters that are a tree of ``ShardedTensor`` s on a mesh of
single-controller chips (``distributed/sharding.py``).  ``forward_train``
runs the rows it is given as one data group (``shard_ctx["group"]``,
default 0; the data axes' split of the batch, the reference's
``_constrain``, is the train step's, ``train_step.data_groups``) on
that group's model chips, the Megatron split of GSPMD under the
reference's ``tp`` rules (``distributed/model_split.py``): inside each
period's body (so ``remat="full"`` regathers in the recompute) each
block asks which chips compute it, chip ``m`` gathers over the data
axis only its own part of each leaf (its heads, ``d_ff`` columns,
experts, ``d_inner`` channels) with differentiable ops, so gradients
land on the blocks, and takes its inputs, every chip's before the first
chip's part (``ModelSplit.run``), then computes a partial output on its
own device; the partials add in
chip order on the group's device at the reference's all-reduce points
(after ``wo``, ``w_down``, the experts' ``combine``, ``out_proj``,
``w_o``, rwkv's ``w_v``, and mamba's ``x_proj`` inside its block).  A
leaf whose rule fell back to replication (a dim ``model`` does not
divide) is computed once.  The embedding splits by vocabulary rows (a
masked lookup and the sum) and the head by vocabulary columns, so
``forward_train_parts`` returns the logits as the chips' vocabulary
shards, which ``Model.loss_fn`` reduces without assembling them;
``forward_train`` concatenates them.  ``shard_ctx["tally"]``
(``model_split.SplitTally``) counts each chip's gathered bytes and
attention calls and the sums.  ``prefill`` and ``forward_decode``
gather each period's weights whole onto the compute device
(``_gather_fsdp``) and compute every head there; their caches keep the
placement they are given.  The reference's XLA-only layout variants
(``gather_fsdp``, ``moe_shard``, ``bf16_ar``: sharding hints and an
``optimization_barrier``) have no eager counterpart.

Three entry points, each on the card unless the caller passes
``device="cpu"``:
  forward_train   full-sequence forward -> (logits, aux)
  prefill         forward + cache construction -> (logits, caches)
  forward_decode  one token against caches -> (logits, caches); it
                  writes the new K/V row, and the recurrent slots' new
                  states, into the caches it is given (in place, where
                  the reference returns updated copies)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed.model_split import ModelSplit
from ..distributed.sharding import LogicalMesh, gather, is_sharded
from ..kernels.ops import resolve_device
from ..pytree import tree_map
from . import layers, mamba, moe, rwkv6, sparse_attention

# sentinel position for unfilled KV-cache slots: +2^30 fails the causal
# test (qpos >= kvpos) so empty slots never attend
UNFILLED_POS = 2 ** 30


def _gather_fsdp(tree, shard_ctx, device):
    """Every sharded leaf of ``tree`` gathered whole onto ``device`` (the
    per-layer ZeRO-3 "gather at use" of prefill and decode); plain
    tensors pass unchanged."""
    if shard_ctx is None:
        return tree
    return tree_map(lambda x: gather(x, device) if is_sharded(x) else x,
                    tree, is_leaf=is_sharded)


def _ctx_device(shard_ctx, device) -> str:
    """The compute device: ``device``, or by default the mesh's first
    chip's."""
    if shard_ctx is not None:
        mesh = shard_ctx["mesh"]
        if not isinstance(mesh, LogicalMesh):
            raise TypeError(f"shard_ctx['mesh'] must be a LogicalMesh, got "
                            f"{type(mesh).__name__}")
        if device is None:
            device = mesh.devices[0]
    return resolve_device(device)


def _device(device) -> str:
    return "meta" if device == "meta" else resolve_device(device)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Parameter init (per slot kind), stacked over periods
# ---------------------------------------------------------------------------

class _Init:
    """Draws leaves with the leading axes ``lead`` (the period axis, or
    none) from one explicit generator (none on the ``meta`` device)."""

    def __init__(self, cfg: ArchConfig, generator, device, lead=()):
        self.gen, self.device, self.lead = generator, device, tuple(lead)
        self.dt = _dtype(cfg)
        self.so = 0.02 / (2 * cfg.num_layers) ** 0.5

    def normal(self, shape, scale, dtype=None):
        return torch.randn(self.lead + tuple(shape), generator=self.gen,
                           dtype=dtype or self.dt, device=self.device) * scale

    def full(self, shape, value, dtype=None):
        return torch.full(self.lead + tuple(shape), value,
                          dtype=dtype or self.dt, device=self.device)

    def log_uniform(self, shape, low, high):
        """float32 exp(U(log low, log high)) draws."""
        u = torch.rand(self.lead + tuple(shape), generator=self.gen,
                       dtype=torch.float32, device=self.device)
        lo, hi = math.log(low), math.log(high)
        return torch.exp(lo + (hi - lo) * u)

    def tile(self, value: torch.Tensor):
        """``value`` (float32, on the CPU) copied to every leading index."""
        value = value.to(self.device)
        return value.expand(self.lead + tuple(value.shape)).clone()


def _init_attn(cfg: ArchConfig, r: _Init):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"ln": r.full((D,), 1.0),
         "wq": r.normal((D, H, hd), 0.02),
         "wk": r.normal((D, KV, hd), 0.02),
         "wv": r.normal((D, KV, hd), 0.02),
         "wo": r.normal((H, hd, D), r.so)}
    if cfg.qkv_bias:
        p["bq"] = r.full((H, hd), 0.0)
        p["bk"] = r.full((KV, hd), 0.0)
        p["bv"] = r.full((KV, hd), 0.0)
    if cfg.qk_norm:
        p["q_norm"] = r.full((hd,), 1.0)
        p["k_norm"] = r.full((hd,), 1.0)
    return p


def _init_xattn(cfg: ArchConfig, r: _Init):
    p = _init_attn(cfg, r)
    p["ln_kv"] = r.full((cfg.d_model,), 1.0)
    p["gate"] = r.full((), 0.0)
    return p


def _init_dense_ffn(cfg: ArchConfig, r: _Init):
    D, F = cfg.d_model, cfg.d_ff
    return {"ln": r.full((D,), 1.0),
            "w_gate": r.normal((D, F), 0.02),
            "w_up": r.normal((D, F), 0.02),
            "w_down": r.normal((F, D), r.so)}


def _init_moe_ffn(cfg: ArchConfig, r: _Init):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"ln": r.full((D,), 1.0),
            "router": r.normal((D, E), 0.02, torch.float32),
            "w_gate": r.normal((E, D, F), 0.02),
            "w_up": r.normal((E, D, F), 0.02),
            "w_down": r.normal((E, F, D), r.so)}


def _init_mamba(cfg: ArchConfig, r: _Init):
    D = cfg.d_model
    Di, N = cfg.mamba_d_inner, cfg.mamba_state
    R, K = cfg.mamba_dt_rank, cfg.mamba_conv
    f32 = torch.float32
    dt_init = r.log_uniform((Di,), 1e-3, 1e-1)
    return {"ln": r.full((D,), 1.0),
            "in_proj": r.normal((D, 2 * Di), 0.02),
            "conv_w": r.normal((K, Di), 0.02),
            "conv_b": r.full((Di,), 0.0),
            "x_proj": r.normal((Di, R + 2 * N), 0.02),
            "dt_proj": r.normal((R, Di), R ** -0.5),
            "dt_bias": torch.log(torch.expm1(dt_init)),
            "A_log": r.tile(torch.log(torch.arange(
                1, N + 1, dtype=f32)).expand(Di, N)),
            "D": r.full((Di,), 1.0, f32),
            "out_proj": r.normal((Di, D), r.so)}


def _init_rwkv(cfg: ArchConfig, r: _Init):
    D, F = cfg.d_model, cfg.d_ff
    H, N = cfg.num_heads, cfg.head_dim
    f32 = torch.float32
    tm = {"ln_w": r.full((D,), 1.0), "ln_b": r.full((D,), 0.0),
          "u": r.normal((H, N), 0.02, f32),
          "w0": r.full((H, N), -5.0, f32),
          "gn_w": r.full((H, N), 1.0, f32),
          "gn_b": r.full((H, N), 0.0, f32)}
    for nm in ("r", "k", "v", "g"):
        tm[f"mu_{nm}"] = r.full((D,), 0.5)
        tm[f"lora_{nm}_a"] = r.normal((D, 32), 0.02, f32)
        tm[f"lora_{nm}_b"] = r.normal((32, D), 0.02, f32)
        tm[f"w_{nm}"] = r.normal((D, H, N), 0.02)
    tm["mu_w"] = r.full((D,), 0.5)
    tm["lora_w_a"] = r.normal((D, 64), 0.02, f32)
    tm["lora_w_b"] = r.normal((64, D), 0.02, f32)
    tm["w_o"] = r.normal((H, N, D), r.so)
    cm = {"ln_w": r.full((D,), 1.0), "ln_b": r.full((D,), 0.0),
          "mu_k": r.full((D,), 0.5), "mu_r": r.full((D,), 0.5),
          "w_k": r.normal((D, F), 0.02),
          "w_v": r.normal((F, D), 0.02),
          "w_r": r.normal((D, D), 0.02)}
    return {"tm": tm, "cm": cm}


# "sattn" (sparse attention, DESIGN.md §13) reuses the attn projection
# stack verbatim — only the attend step differs
_SLOT_INIT = {"attn": _init_attn, "xattn": _init_xattn, "sattn": _init_attn,
              "mamba": _init_mamba, "rwkv": _init_rwkv}
_FFN_INIT = {"dense": _init_dense_ffn, "moe": _init_moe_ffn}


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device=None) -> Dict[str, Any]:
    """The reference's parameter tree, distributions and scales (normal
    draws times 0.02, output projections times 0.02 / sqrt(2 L), norms
    ones, biases and gates zeros, the router and the recurrent slots'
    scan parameters in float32), drawn from
    ``generator`` on ``device`` (the card unless ``"cpu"``; ``"meta"``
    allocates nothing).  ``generator`` defaults to one seeded 0 on that
    device; its numbers are not the reference's, whose RNG differs."""
    device = _device(device)
    if device == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    top = _Init(cfg, generator, device)
    params: Dict[str, Any] = {
        "embed": top.normal((cfg.vocab_size, cfg.d_model), 0.02),
        "final_norm": top.full((cfg.d_model,), 1.0),
        "lm_head": top.normal((cfg.d_model, cfg.vocab_size), 0.02),
        "period": {},
    }
    r = _Init(cfg, generator, device, (cfg.num_periods,))
    for i, kind in enumerate(cfg.pattern):
        slot = {kind: _SLOT_INIT[kind](cfg, r)}
        fk = cfg.ffn_kind(i)
        if fk != "none":
            slot["ffn_" + fk] = _FFN_INIT[fk](cfg, r)
        params["period"][f"slot{i}"] = slot
    return params


def _at(tree, index: int):
    """Period ``index`` of a period-stacked tree (views, no copies)."""
    return {k: _at(v, index) if isinstance(v, dict)
            else v.period(index) if is_sharded(v) else v[index]
            for k, v in tree.items()}


def _top(params, shard_ctx, device):
    """The embedding, final norm and head, gathered when sharded."""
    return _gather_fsdp({k: v for k, v in params.items() if k != "period"},
                        shard_ctx, device)


# ---------------------------------------------------------------------------
# Slot application
# ---------------------------------------------------------------------------

def _apply_ffn(cfg, slot_params, x, split=None):
    aux = {}
    if "ffn_dense" in slot_params:
        x = layers.swiglu_mlp(slot_params["ffn_dense"], x,
                              norm_eps=cfg.norm_eps, split=split)
    elif "ffn_moe" in slot_params:
        x, aux = moe.moe_ffn(slot_params["ffn_moe"], x,
                             num_experts=cfg.num_experts, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             norm_eps=cfg.norm_eps, split=split)
    return x, aux


def _apply_slot_train(cfg: ArchConfig, kind: str, slot_params, x, positions,
                      image_embeds, chunk_q, *, split: ModelSplit,
                      causal_skip=False, backend="auto", staging=None,
                      device=None):
    if kind == "attn":
        x = layers.self_attention_layer(
            slot_params["attn"], x, positions=positions,
            head_dim=cfg.head_dim, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
            causal=True, window=cfg.sliding_window, qk_norm=cfg.qk_norm,
            norm_eps=cfg.norm_eps, chunk_q=chunk_q, causal_skip=causal_skip,
            split=split)
    elif kind == "sattn":
        x = sparse_attention.sparse_self_attention_layer(
            slot_params["sattn"], x, positions=positions,
            head_dim=cfg.head_dim, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads,
            window=cfg.sparse_attn_window,
            num_global=cfg.sparse_attn_global,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            norm_eps=cfg.norm_eps, backend=backend, staging=staging,
            device=device, split=split)
    elif kind == "xattn":
        x = layers.cross_attention_layer(
            slot_params["xattn"], x, image_embeds, head_dim=cfg.head_dim,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, chunk_q=chunk_q,
            split=split)
    elif kind == "mamba":
        x = mamba.mamba_block(slot_params[kind], x, state_dim=cfg.mamba_state,
                              conv_width=cfg.mamba_conv,
                              norm_eps=cfg.norm_eps, split=split)
    elif kind == "rwkv":
        x = rwkv6.rwkv_block(slot_params[kind], x, num_heads=cfg.num_heads,
                             head_dim=cfg.head_dim, norm_eps=cfg.norm_eps,
                             split=split)
    else:
        raise ValueError(kind)
    return _apply_ffn(cfg, slot_params, x, split)


def _head(cfg, params, x):
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(x.dtype))


def _embed(split: ModelSplit, embed, tokens):
    """Token embeddings, by vocabulary rows over the model chips where
    the rules split them: each chip looks up the tokens its rows hold
    (zeros elsewhere), and the chips' lookups add."""
    chips = split.chips_for(embed, 0)
    if len(chips) == 1:
        return split.take(embed, chips[0])[split.to(tokens, chips[0])]

    def take(m):
        lo, hi = split.owned(embed, 0, m)
        return lo, hi, split.take(embed, m, 0, [(lo, hi)]), \
            split.to(tokens, m)

    def part(m, lo, hi, rows, tok):
        local = tok.long() - lo
        mine = (local >= 0) & (local < hi - lo)
        e = rows[local.clamp(0, hi - lo - 1)]
        return torch.where(mine[..., None], e, e.new_zeros(()))

    return split.sum(split.run(chips, take, part))


def _head_parts(cfg, split: ModelSplit, top, x):
    """The final norm (once) and the head by vocabulary columns over the
    model chips: (each chip's float32 logits (B, S, V_m) on its device,
    each shard's first column)."""
    x = layers.rms_norm(x, split.take(top["final_norm"]), cfg.norm_eps)
    head = top["lm_head"]
    chips = split.chips_for(head, 1)

    def take(m):
        lo, hi = split.owned(head, 1, m)
        return split.take(head, m, 1, [(lo, hi)]), split.to(x, m)

    def part(m, w, xm):
        return torch.einsum("bsd,dv->bsv", xm, w.to(x.dtype)).float()

    shards = split.run(chips, take, part)
    return shards, [split.owned(head, 1, m)[0] for m in chips]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


# ---------------------------------------------------------------------------
# Train forward
# ---------------------------------------------------------------------------

def forward_train_parts(cfg: ArchConfig, params, tokens, *,
                        image_embeds=None, remat: str = "full",
                        chunk_q: int = 512, shard_ctx=None,
                        causal_skip: bool = False, backend: str = "auto",
                        staging: Optional[str] = None, device=None):
    """:func:`forward_train` with the logits left as the model chips'
    vocabulary shards: ``(shards, starts, aux)``, shard ``m`` the
    float32 logits (B, S, V_m) of columns ``starts[m]`` on, on its chip's
    device (one shard, all columns, where the head is not split)."""
    if remat not in ("none", "full"):
        raise ValueError(f"remat={remat!r}: 'none' or 'full'")
    device = _ctx_device(shard_ctx, device)
    split = ModelSplit.of(shard_ctx, device)
    tokens = tokens.to(device)
    B, S = tokens.shape
    top = {k: v for k, v in params.items() if k != "period"}
    x = _embed(split, top["embed"], tokens)
    positions = _positions(B, S, device)

    def period_body(x, period_params):
        aux_total = torch.zeros((), dtype=torch.float32, device=device)
        for i, kind in enumerate(cfg.pattern):
            x, aux = _apply_slot_train(
                cfg, kind, period_params[f"slot{i}"], x, positions,
                image_embeds, chunk_q, split=split, causal_skip=causal_skip,
                backend=backend, staging=staging, device=device)
            if aux:
                aux_total = aux_total + aux["moe_lb_loss"] \
                    + 1e-3 * aux["moe_z_loss"]
        return x, aux_total

    remat_on = remat == "full" and torch.is_grad_enabled()
    aux_sum = torch.zeros((), dtype=torch.float32, device=device)
    for index in range(cfg.num_periods):
        period_params = _at(params["period"], index)
        if remat_on:
            x, aux = checkpoint(period_body, x, period_params,
                                use_reentrant=False)
        else:
            x, aux = period_body(x, period_params)
        aux_sum = aux_sum + aux
    shards, starts = _head_parts(cfg, split, top, x)
    return shards, starts, {"moe_aux": aux_sum}


def forward_train(cfg: ArchConfig, params, tokens, *, image_embeds=None,
                  remat: str = "full", chunk_q: int = 512, shard_ctx=None, causal_skip: bool = False,
                  backend: str = "auto", staging: Optional[str] = None,
                  device=None):
    """tokens (B, S) -> (logits (B, S, V) float32, {"moe_aux": scalar}).

    ``remat`` is ``"full"`` (checkpoint each period when grad is on) or
    ``"none"``.  ``backend``/``staging`` are the ``sattn`` slots'
    attention artifact knobs (``"auto"`` is ``pallas_bcsr`` on the card,
    and ``staging`` ``None`` its ``"dma"``: one K6 launch per (batch,
    head) a layer, per model chip on its own heads under ``shard_ctx``).
    Under ``shard_ctx`` the logits are the vocabulary shards
    concatenated on the group's device.
    """
    shards, _, aux = forward_train_parts(
        cfg, params, tokens, image_embeds=image_embeds, remat=remat,
        chunk_q=chunk_q, shard_ctx=shard_ctx, causal_skip=causal_skip,
        backend=backend, staging=staging, device=device)
    if len(shards) == 1:
        return shards[0], aux
    dev = _ctx_device(shard_ctx, device)
    return torch.cat([t.to(dev) for t in shards], dim=-1), aux


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------

def attn_cache_len(cfg: ArchConfig, cache_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, cache_len)
    return cache_len


def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                      device=None):
    """Zero caches (stacked over periods) for decode, on ``device`` (the
    card unless ``"cpu"``; ``"meta"`` for shapes only): K/V rings, the
    mamba slots' SSM state (float32) and conv buffer, the rwkv slots' wkv
    state (float32) and token-shift rows."""
    device = _device(device)
    dt = _dtype(cfg)
    P = cfg.num_periods
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    caches = {}
    for i, kind in enumerate(cfg.pattern):
        if kind in ("attn", "sattn"):
            # sattn keeps the FULL cache: rolling window eviction would
            # drop the global tokens every later query must still see
            T = cache_len if kind == "sattn" \
                else attn_cache_len(cfg, cache_len)
            caches[f"slot{i}"] = {
                "k": torch.zeros((P, batch, T, KV, hd), dtype=dt,
                                 device=device),
                "v": torch.zeros((P, batch, T, KV, hd), dtype=dt,
                                 device=device),
                "kpos": torch.full((P, batch, T), UNFILLED_POS,
                                   dtype=torch.int32, device=device),
            }
        elif kind == "xattn":
            n_img = cfg.num_image_tokens
            caches[f"slot{i}"] = {
                "xk": torch.zeros((P, batch, n_img, KV, hd), dtype=dt,
                                  device=device),
                "xv": torch.zeros((P, batch, n_img, KV, hd), dtype=dt,
                                  device=device),
            }
        elif kind == "mamba":
            Di, N, K = cfg.mamba_d_inner, cfg.mamba_state, cfg.mamba_conv
            caches[f"slot{i}"] = {
                "ssm": torch.zeros((P, batch, Di, N), dtype=torch.float32,
                                   device=device),
                "conv": torch.zeros((P, batch, K - 1, Di), dtype=dt,
                                    device=device),
            }
        elif kind == "rwkv":
            H, N, D = cfg.num_heads, cfg.head_dim, cfg.d_model
            caches[f"slot{i}"] = {
                "wkv": torch.zeros((P, batch, H, N, N), dtype=torch.float32,
                                   device=device),
                "x_prev_tm": torch.zeros((P, batch, D), dtype=dt,
                                         device=device),
                "x_prev_cm": torch.zeros((P, batch, D), dtype=dt,
                                         device=device),
            }
    return caches


# ---------------------------------------------------------------------------
# Decode step (one new token against the caches)
# ---------------------------------------------------------------------------

def _decode_attn(cfg, p, x, cache, pos: int, *, window=None, num_global=0):
    """One position through an (s)attn slot; ``cache`` holds one period's
    views, into which the new K/V row and position are written at the
    ring index ``pos % T``."""
    B = x.shape[0]
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = layers.attn_project_qkv(p, h, cfg.num_heads, cfg.num_kv_heads,
                                      cfg.head_dim, qk_norm=cfg.qk_norm,
                                      norm_eps=cfg.norm_eps)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = layers.apply_rope(q, posb, cfg.rope_theta)
    k = layers.apply_rope(k, posb, cfg.rope_theta)
    idx = pos % cache["k"].shape[1]
    cache["k"][:, idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, idx] = v[:, 0].to(cache["v"].dtype)
    cache["kpos"][:, idx] = pos
    out = layers.gqa_attention(q, cache["k"], cache["v"], q_positions=posb,
                               kv_positions=cache["kpos"], causal=True,
                               window=window, num_global=num_global)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return x + out


def _decode_xattn(cfg, p, x, cache):
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(x.dtype))
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
    B = x.shape[0]
    n_img = cache["xk"].shape[1]
    qpos = torch.zeros((B, 1), dtype=torch.int32, device=x.device)
    kpos = torch.zeros((B, n_img), dtype=torch.int32, device=x.device)
    out = layers.gqa_attention(q, cache["xk"], cache["xv"],
                               q_positions=qpos, kv_positions=kpos,
                               causal=False)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    gate = torch.tanh(p["gate"].float()).to(x.dtype)
    return x + gate * out


def _recurrent(cfg: ArchConfig, kind: str, p, x, init_state=None):
    """A mamba or rwkv slot over x, returning (x, its new state)."""
    if kind == "mamba":
        return mamba.mamba_block(p, x, state_dim=cfg.mamba_state,
                                 conv_width=cfg.mamba_conv,
                                 norm_eps=cfg.norm_eps,
                                 init_state=init_state, return_state=True)
    return rwkv6.rwkv_block(p, x, num_heads=cfg.num_heads,
                            head_dim=cfg.head_dim, norm_eps=cfg.norm_eps,
                            init_state=init_state, return_state=True)


def _decode_recurrent(cfg, kind, p, x, cache):
    """One position through a mamba or rwkv slot from the state in
    ``cache`` (one period's views), into which the new state is written."""
    x, state = _recurrent(cfg, kind, p, x, init_state=cache)
    for name, value in state.items():
        cache[name].copy_(value)
    return x


def forward_decode(cfg: ArchConfig, params, token, caches, pos, *,
                   shard_ctx=None, device=None):
    """token (B, 1) integer; ``pos`` an int (or 0-d tensor); caches from
    ``init_decode_cache``/``prefill``, updated in place and returned.
    Under ``shard_ctx`` each period's weights are gathered whole onto
    the compute device, which computes every head: decode does not
    split over ``model``, and the caches keep their placement."""
    device = _ctx_device(shard_ctx, device)
    pos = int(pos)
    top = _top(params, shard_ctx, device)
    x = top["embed"][token.to(device)]
    for index in range(cfg.num_periods):
        period_params = _gather_fsdp(_at(params["period"], index),
                                     shard_ctx, device)
        for i, kind in enumerate(cfg.pattern):
            sp = period_params[f"slot{i}"]
            cache = _at(caches[f"slot{i}"], index)
            if kind == "attn":
                x = _decode_attn(cfg, sp["attn"], x, cache, pos,
                                 window=cfg.sliding_window)
            elif kind == "sattn":
                # serve-side fallback: dense masked attention with the
                # SAME window+global mask the fused train path encodes
                # in its CSR structure (the diagonal is always present)
                x = _decode_attn(cfg, sp["sattn"], x, cache, pos,
                                 window=cfg.sparse_attn_window,
                                 num_global=cfg.sparse_attn_global)
            elif kind == "xattn":
                x = _decode_xattn(cfg, sp["xattn"], x, cache)
            else:
                x = _decode_recurrent(cfg, kind, sp[kind], x, cache)
            x, _ = _apply_ffn(cfg, sp, x)
    return _head(cfg, top, x).float(), caches


# ---------------------------------------------------------------------------
# Prefill (forward + cache build) — serving path
# ---------------------------------------------------------------------------

def _filled(t, T: int, fill=0):
    """(B, T, ...) ring cache holding the last min(S, T) rows of t
    (B, S, ...), the row at position p in slot p % T (where
    ``_decode_attn`` writes position p), ``fill`` elsewhere.  The
    reference puts them in the first slots, which decode then overwrites
    out of order once a prompt longer than the ring is not a multiple of
    it; for every other prompt the two layouts are the same."""
    S = t.shape[1]
    keep = min(S, T)
    out = t.new_full((t.shape[0], T) + tuple(t.shape[2:]), fill)
    out[:, torch.arange(S - keep, S, device=t.device) % T] = t[:, S - keep:]
    return out


def prefill(cfg: ArchConfig, params, tokens, cache_len: int, *,
            image_embeds=None, chunk_q: int = 512, shard_ctx=None, causal_skip: bool = False, device=None):
    """tokens (B, S) -> (logits (B, S, V) float32, caches stacked over
    periods).  ``sattn`` slots take the dense masked fallback, as in the
    reference, with a full-length cache (global tokens must survive);
    the recurrent slots' caches are their states after the prompt.
    Under ``shard_ctx`` each period's weights are gathered whole onto
    the compute device, which computes every head: prefill does not
    split over ``model``."""
    device = _ctx_device(shard_ctx, device)
    tokens = tokens.to(device)
    B, S = tokens.shape
    top = _top(params, shard_ctx, device)
    x = top["embed"][tokens]
    positions = _positions(B, S, device)
    per_period = []
    for index in range(cfg.num_periods):
        period_params = _gather_fsdp(_at(params["period"], index),
                                     shard_ctx, device)
        new_caches = {}
        for i, kind in enumerate(cfg.pattern):
            sp = period_params[f"slot{i}"]
            if kind in ("attn", "sattn"):
                p = sp[kind]
                h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
                q, k, v = layers.attn_project_qkv(
                    p, h, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
                q = layers.apply_rope(q, positions, cfg.rope_theta)
                k = layers.apply_rope(k, positions, cfg.rope_theta)
                if kind == "attn" and causal_skip:
                    out = layers.gqa_attention_causal_skip(
                        q, k, v, q_positions=positions,
                        kv_positions=positions, window=cfg.sliding_window,
                        chunk_q=chunk_q)
                elif kind == "attn":
                    out = layers.gqa_attention(
                        q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True,
                        window=cfg.sliding_window, chunk_q=chunk_q)
                else:
                    out = layers.gqa_attention(
                        q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True,
                        window=cfg.sparse_attn_window,
                        num_global=cfg.sparse_attn_global, chunk_q=chunk_q)
                x = x + torch.einsum("bshk,hkd->bsd", out,
                                     p["wo"].to(x.dtype))
                T = cache_len if kind == "sattn" \
                    else attn_cache_len(cfg, cache_len)
                new_caches[f"slot{i}"] = {
                    "k": _filled(k, T), "v": _filled(v, T),
                    "kpos": _filled(positions, T, UNFILLED_POS)}
            elif kind in ("mamba", "rwkv"):
                x, new_caches[f"slot{i}"] = _recurrent(cfg, kind, sp[kind],
                                                       x)
            else:
                p = sp["xattn"]
                kv = layers.rms_norm(image_embeds, p["ln_kv"], cfg.norm_eps)
                xk = torch.einsum("bsd,dhk->bshk", kv, p["wk"].to(x.dtype))
                xv = torch.einsum("bsd,dhk->bshk", kv, p["wv"].to(x.dtype))
                if cfg.qk_norm:
                    xk = layers.rms_norm(xk, p["k_norm"], cfg.norm_eps)
                x = layers.cross_attention_layer(
                    p, x, image_embeds, head_dim=cfg.head_dim,
                    num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                    qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps,
                    chunk_q=chunk_q)
                new_caches[f"slot{i}"] = {"xk": xk, "xv": xv}
            x, _ = _apply_ffn(cfg, sp, x)
        per_period.append(new_caches)
    caches = {slot: {name: torch.stack([c[slot][name] for c in per_period])
                     for name in per_period[0][slot]}
              for slot in per_period[0]}
    return _head(cfg, top, x).float(), caches
