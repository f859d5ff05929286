"""The transformer layers the ``sattn`` slot uses (port of the matching
functions of ``src/repro/models/layers.py``): RMS norm, RoPE and the
Q/K/V projections.

Functions are pure; parameters are plain dicts of tensors.  The compute
dtype is the tensor's dtype; norm statistics are float32.
"""
from __future__ import annotations

import torch


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


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
