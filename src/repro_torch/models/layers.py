"""Core transformer layers (port of ``src/repro/models/layers.py``):
norms, RoPE, GQA attention (QKV bias, qk_norm, sliding window, global
columns, cross-attention), SwiGLU MLP.

Functions are pure; parameters are plain dicts of tensors.  The compute
dtype is the tensor's dtype; softmax and norm statistics are float32,
and attention scores are accumulated in float32 as the reference's
``preferred_element_type`` asks.  Attention is query-chunked when
``Sq > chunk_q`` (a Python loop over chunks where the reference maps
over them), so the (S x S) score matrix is never held whole.  The dense
attention and the FFN products are plain ``torch.einsum``: the reference
computes them outside any Pallas kernel.

The attention layers and the SwiGLU MLP take a ``split``
(``distributed.model_split.ModelSplit``, one data group's model chips):
each chip computes its own query heads (with the KV heads they read)
or ``d_ff`` columns from its part of the weights, and the chips'
partial outputs add on the group's device before the residual.  With
no split the block is one computation over the plain weights given.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed.model_split import ModelSplit, kv_heads

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * weight.float() + bias.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x (..., S, H, hd); positions (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)        # (hd/2,)
    ang = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention core (query-chunked, GQA, causal / windowed / cross)
# ---------------------------------------------------------------------------

def _attend(q, k, v, mask):
    """q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask (B|1,Sq,Sk) bool or None."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             scores.new_full((), NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype), v)


def gqa_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                  window: Optional[int] = None, num_global: int = 0,
                  chunk_q: int = 512):
    """Grouped-query attention.

    q (B,Sq,H,hd), k/v (B,Sk,KV,hd).  H % KV == 0; G = H // KV.
    Causal/window masks are built from explicit positions so the same
    code serves training (positions 0..S) and decode (one new position
    against a cache).  ``num_global`` widens the window mask with
    longformer-style global key columns (positions < num_global stay
    visible to every later query) — the dense fallback for the sparse-
    attention ("sattn") serving paths; still ANDed with the causal
    test, so unfilled cache slots (UNFILLED_POS = +2^30) stay masked.
    Query-chunked when Sq > chunk_q.
    """
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)

    def mask_for(qpos):
        m = None
        if causal:
            m = qpos[:, :, None] >= kv_positions[:, None, :]
        if window is not None:
            wm = qpos[:, :, None] - kv_positions[:, None, :] < window
            if num_global:
                wm = wm | (kv_positions[:, None, :] < num_global)
            m = wm if m is None else (m & wm)
        return m

    if Sq <= chunk_q:
        return _attend(qg, k, v, mask_for(q_positions)).reshape(B, Sq, H, hd)
    assert Sq % chunk_q == 0, (Sq, chunk_q)
    outs = [_attend(qg[:, i:i + chunk_q], k, v,
                    mask_for(q_positions[:, i:i + chunk_q]))
            for i in range(0, Sq, chunk_q)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def gqa_attention_causal_skip(q, k, v, *, q_positions, kv_positions,
                              window: Optional[int] = None,
                              chunk_q: int = 512):
    """Causal chunked attention with block skipping: query chunk i only
    attends kv[lo_i : (i+1)*chunk_q] (positions are the standard aligned
    0..S layout), with lo_i = max(0, hi_i - window - chunk_q) under a
    sliding window, so fully-masked score blocks are never computed."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    if Sq <= chunk_q:
        m = q_positions[:, :, None] >= kv_positions[:, None, :]
        if window is not None:
            m &= q_positions[:, :, None] - kv_positions[:, None, :] < window
        return _attend(qg, k, v, m).reshape(B, Sq, H, hd)
    assert Sq % chunk_q == 0
    outs = []
    for i in range(Sq // chunk_q):
        hi = (i + 1) * chunk_q
        lo = 0 if window is None else max(0, hi - window - chunk_q)
        qp = q_positions[:, i * chunk_q: hi]
        kp = kv_positions[:, lo:hi]
        m = qp[:, :, None] >= kp[:, None, :]
        if window is not None:
            m &= qp[:, :, None] - kp[:, None, :] < window
        outs.append(_attend(qg[:, i * chunk_q: hi], k[:, lo:hi],
                            v[:, lo:hi], m))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Attention layer (projections + rope + attend)
# ---------------------------------------------------------------------------

def attn_project_qkv(p, x, cfg_heads, cfg_kv_heads, head_dim, *, qk_norm,
                     norm_eps):
    """Q (B, S, H, hd) and K, V (B, S, KV, hd) from x (B, S, D)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if qk_norm:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    return q, k, v


def attn_chips(split: ModelSplit, p) -> list:
    """The model chips that compute an attention block (``chips_for``
    of ``wq``'s heads).  ``wq`` (D, H, hd) and ``wo`` (H, hd, D) carry
    the head on a dim of its own, so a split of it is whole heads."""
    chips = split.chips_for(p["wq"], 1)
    if split.chips_for(p["wo"], 0) != chips:
        raise ValueError("wq and wo must split the same heads")
    return chips


def attn_take(split: ModelSplit, p, num_heads: int, num_kv_heads: int, m):
    """Chip ``m``'s ``(leaves, idx)`` of an attention block: ``wq``/
    ``bq``/``wo`` of its query heads, ``wk``/``wv``/``bk``/``bv`` of the
    KV heads those read, the norms whole, and ``idx`` (``kv_heads``:
    None, or each local query head's KV head, for :func:`per_head`)."""
    heads = split.owned(p["wq"], 1, m)
    kv, idx = kv_heads(*heads, num_heads // num_kv_heads)
    leaves = {"wq": split.take(p["wq"], m, 1, [heads]),
              "wk": split.take(p["wk"], m, 1, [kv]),
              "wv": split.take(p["wv"], m, 1, [kv]),
              "wo": split.take(p["wo"], m, 0, [heads])}
    if "bq" in p:
        leaves["bq"] = split.take(p["bq"], m, 0, [heads])
        leaves["bk"] = split.take(p["bk"], m, 0, [kv])
        leaves["bv"] = split.take(p["bv"], m, 0, [kv])
    for name in ("q_norm", "k_norm"):
        if name in p:
            leaves[name] = split.take(p[name], m)
    return leaves, idx


def per_head(t, idx):
    """``t`` (B, S, KV, hd) with one KV head per query head when the
    chip's query heads do not fall on its KV heads in equal groups."""
    return t if idx is None else t[:, :, idx]


def self_attention_layer(p, x, *, positions, head_dim, num_heads,
                         num_kv_heads, rope_theta, causal=True,
                         window=None, qk_norm=False, norm_eps=1e-5,
                         kv_override=None, chunk_q: int = 512,
                         causal_skip: bool = False,
                         split: Optional[ModelSplit] = None):
    """Pre-norm self-attention block: x + attn(norm(x)).

    kv_override: (k, v, kv_positions) for decode-with-cache paths.
    ``split``: the model chips, each on its own heads; a split of more
    than one chip takes no ``kv_override`` (a decode cache holds every
    KV head, a chip only its own).
    """
    split = split or ModelSplit(x.device)
    if split.tp > 1 and kv_override is not None:
        raise ValueError("the model split runs the training forward: no "
                         "decode cache")
    h = rms_norm(x, split.take(p["ln"]), norm_eps)

    def take(m):
        return (*attn_take(split, p, num_heads, num_kv_heads, m),
                split.to(h, m), split.to(positions, m))

    def part(m, lp, idx, hm, pos):
        q, k, v = attn_project_qkv(lp, hm, num_heads, num_kv_heads,
                                   head_dim, qk_norm=qk_norm,
                                   norm_eps=norm_eps)
        q = apply_rope(q, pos, rope_theta)
        if kv_override is None:
            k = apply_rope(k, pos, rope_theta)
            kv_positions = pos
        else:
            k, v, kv_positions = kv_override(k, v)
        k, v = per_head(k, idx), per_head(v, idx)
        if causal_skip and causal and kv_override is None:
            out = gqa_attention_causal_skip(
                q, k, v, q_positions=pos, kv_positions=kv_positions,
                window=window, chunk_q=chunk_q)
        else:
            out = gqa_attention(q, k, v, q_positions=pos,
                                kv_positions=kv_positions, causal=causal,
                                window=window, chunk_q=chunk_q)
        return torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(x.dtype))

    return x + split.sum(split.run(attn_chips(split, p), take, part))


def cross_attention_layer(p, x, kv_src, *, head_dim, num_heads,
                          num_kv_heads, qk_norm=False, norm_eps=1e-5,
                          chunk_q: int = 512,
                          split: Optional[ModelSplit] = None):
    """Cross-attention block (llama-3.2-vision image layers): queries from
    the text stream, keys/values from image embeddings; no causal mask,
    no RoPE; gated residual (tanh gate, init 0) as in llama-3.2, the
    gate on the chips' summed output."""
    split = split or ModelSplit(x.device)
    h = rms_norm(x, split.take(p["ln"]), norm_eps)
    kv = rms_norm(kv_src, split.take(p["ln_kv"]), norm_eps)

    def take(m):
        return (*attn_take(split, p, num_heads, num_kv_heads, m),
                split.to(h, m), split.to(kv, m))

    def part(m, lp, idx, hm, kvm):
        q = torch.einsum("bsd,dhk->bshk", hm, lp["wq"].to(x.dtype))
        k = torch.einsum("bsd,dhk->bshk", kvm, lp["wk"].to(x.dtype))
        v = torch.einsum("bsd,dhk->bshk", kvm, lp["wv"].to(x.dtype))
        if qk_norm:
            q = rms_norm(q, lp["q_norm"], norm_eps)
            k = rms_norm(k, lp["k_norm"], norm_eps)
        k, v = per_head(k, idx), per_head(v, idx)
        B, Sq = q.shape[:2]
        Sk = k.shape[1]
        qpos = torch.zeros((B, Sq), dtype=torch.int32, device=q.device)
        kpos = torch.zeros((B, Sk), dtype=torch.int32, device=q.device)
        out = gqa_attention(q, k, v, q_positions=qpos, kv_positions=kpos,
                            causal=False, chunk_q=chunk_q)
        return torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(x.dtype))

    gate = torch.tanh(split.take(p["gate"]).float()).to(x.dtype)
    return x + gate * split.sum(split.run(attn_chips(split, p), take, part))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(p, x, *, norm_eps=1e-5, split: Optional[ModelSplit] = None):
    """Pre-norm SwiGLU FFN block: x + W_down(silu(W_gate h) * W_up h);
    under ``split`` each chip takes its ``d_ff`` columns of W_gate/W_up
    and rows of W_down."""
    split = split or ModelSplit(x.device)
    h = rms_norm(x, split.take(p["ln"]), norm_eps)

    def take(m):
        cols = [split.owned(p["w_gate"], 1, m)]
        return (split.to(h, m), split.take(p["w_gate"], m, 1, cols),
                split.take(p["w_up"], m, 1, cols),
                split.take(p["w_down"], m, 0, cols))

    def part(m, hm, w_gate, w_up, w_down):
        g = torch.einsum("bsd,df->bsf", hm, w_gate.to(x.dtype))
        u = torch.einsum("bsd,df->bsf", hm, w_up.to(x.dtype))
        act = torch.nn.functional.silu(g.float()).to(x.dtype) * u
        return torch.einsum("bsf,fd->bsd", act, w_down.to(x.dtype))

    chips = split.chips_for(p["w_gate"], 1)
    return x + split.sum(split.run(chips, take, part))
