"""Sparse-attention ("sattn") transformer slot: the fused sandwich as a
model layer (port of ``src/repro/models/sparse_attention.py``).

The mask is longformer-style — a causal sliding window plus a set of
global key columns every later query can see — built once per sequence
length as a :class:`~repro_torch.core.CSRMatrix` and compiled into the
fused SDDMM → online softmax → S·V artifact
(:func:`~repro_torch.core.compile_sparse_attention`).  The (batch, head)
instances all share one structure, so they share one artifact; each is
one fused launch, with the score matrix never in device memory.  The
layer calls the artifact once on all its (batch, head) instances: a
launch each, as the reference's loop over them, and one backward over
them all, each chunk of it over every instance.  Under a model split
(``distributed.model_split``) each model chip calls it on its own
heads only, so K6 is launched per chip on its own heads, against the
one shared artifact.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import layers


def sparse_attention_mask(seq_len: int, window: int, num_global: int = 0, *,
                          device=None):
    """Causal sliding-window + global-column mask as a CSRMatrix with
    unit weights on ``device`` (the card unless ``"cpu"``).

    Row i (query) sees key j iff ``j <= i`` and (``i - j < window`` or
    ``j < num_global``): the columns ``[0, min(lo, g))`` then
    ``[lo, i]`` with ``lo = max(0, i - window + 1)``.  The diagonal is
    always present (window >= 1), so no row is empty.
    """
    from ..core import CSRMatrix
    from ..kernels.ops import resolve_device
    assert window >= 1, window
    S = int(seq_len)
    g = min(int(num_global), S)
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1)
    n_glob = np.minimum(lo, g)
    lengths = n_glob + (i - lo + 1)
    row_ptr = np.zeros(S + 1, np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    # entry e of row i: e < n_glob[i] is global column e, the rest run
    # from lo[i]
    e = np.arange(row_ptr[-1], dtype=np.int64) - np.repeat(row_ptr[:-1],
                                                           lengths)
    glob = np.repeat(n_glob, lengths)
    cols = np.where(e < glob, e, np.repeat(lo, lengths) + e - glob)
    vals = torch.ones(int(row_ptr[-1]), dtype=torch.float32,
                      device=resolve_device(device))
    return CSRMatrix((S, S), row_ptr, cols.astype(np.int32), vals)


@functools.lru_cache(maxsize=64)
def _mask_and_artifact(seq_len: int, head_dim: int, window: int,
                       num_global: int, backend: str, device: str,
                       staging: Optional[str] = None):
    from ..core import compile_sparse_attention
    a = sparse_attention_mask(seq_len, window, num_global, device=device)
    art = compile_sparse_attention(a, head_dim, head_dim, backend=backend,
                                   device=device, staging=staging)
    return a, art


def sparse_self_attention_layer(p, x, *, positions, head_dim, num_heads,
                                num_kv_heads, window, num_global=0,
                                rope_theta=1e4, qk_norm=False,
                                norm_eps=1e-5, backend="auto",
                                device: Optional[str] = None,
                                staging: Optional[str] = None, split=None):
    """Pre-norm sparse self-attention block: x + sattn(norm(x)).

    ``p`` holds ``ln`` (D,), ``wq`` (D, H, hd), ``wk``/``wv``
    (D, KV, hd) and ``wo`` (H, hd, D); ``x`` is (B, S, D) and
    ``positions`` (B, S).  The attend step runs the fused artifact on
    every (batch, head) at once with GQA head sharing (kv head = h //
    (H // KV)).
    ``device`` is resolved as for every entry point (the card unless
    ``"cpu"``) and joins the artifact's cache key; ``staging`` is the
    artifact's (``None`` = the card's ``"dma"``: K6; ``"resident"``:
    K5).  ``split`` (a ``ModelSplit``): each model chip projects, attends
    and applies ``wo`` for its own heads on its own device, and the
    partial outputs add on the group's.
    """
    from ..distributed.model_split import ModelSplit
    from ..kernels.ops import resolve_device
    device = resolve_device(device)
    split = split or ModelSplit(device)
    B, S, _ = x.shape
    h = layers.rms_norm(x, split.take(p["ln"]), norm_eps)

    def take(m):
        # the chip's artifact too: its first build on a card copies the
        # mask's tables there, a host wait kept out of the parts
        art = _mask_and_artifact(S, head_dim, int(window), int(num_global),
                                 backend, resolve_device(split.on(m)),
                                 staging)
        return (*layers.attn_take(split, p, num_heads, num_kv_heads, m),
                split.to(h, m), split.to(positions, m), *art)

    def part(m, lp, idx, hm, pos, a, art):
        q, k, v = layers.attn_project_qkv(lp, hm, num_heads, num_kv_heads,
                                          head_dim, qk_norm=qk_norm,
                                          norm_eps=norm_eps)
        q = layers.apply_rope(q, pos, rope_theta)
        k = layers.apply_rope(k, pos, rope_theta)
        k, v = layers.per_head(k, idx), layers.per_head(v, idx)
        H = q.shape[2]

        def instances(t):
            # (B, S, heads, hd) -> (B·H, S, hd), query head hh reading
            # KV head hh // (H // heads)
            t = t[:, :, :, None].expand(B, S, t.shape[2], H // t.shape[2],
                                        t.shape[3]).reshape(B, S, H, -1)
            return t.permute(0, 2, 1, 3).reshape(B * H, S, -1).float()

        # one call: a K6 launch each (batch, head), one backward for all
        y = art(a.vals, instances(q), instances(k), instances(v))
        split.count_attn(m, B * H)
        out = y.reshape(B, H, S, -1).permute(0, 2, 1, 3).to(x.dtype)
        return torch.einsum("bshk,hkd->bsd", out, lp["wo"].to(x.dtype))

    return x + split.sum(split.run(layers.attn_chips(split, p), take, part))
