"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix
(port of ``src/repro/models/rwkv6.py``).

The wkv recurrence per head (state S ∈ R^{N x N}):
    out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
    S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t
with w_t data-dependent (the Finch contribution).  A sequence runs in
chunks of ``chunk`` steps carrying the (B, H, N, N) state; within a
chunk the steps run one after another.  Under autograd each chunk is a
``torch.utils.checkpoint`` region, as the reference ``jax.checkpoint``s
its chunk body, so the backward recomputes a chunk's states instead of
keeping one per position.  Decode is the O(1) single-step update.  The
recurrence is plain torch: the reference computes it outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import layer_norm


def _lora(x, a, b):
    """Low-rank data-dependent modulation: tanh(x A) B."""
    return torch.tanh(x @ a) @ b


def _token_shift(x, x_prev_last):
    """(B,S,D) -> previous-token stream; x_prev_last (B,D) seeds t=0."""
    return torch.cat([x_prev_last[:, None], x[:, :-1]], dim=1)


def _wkv_chunk(state, r, k, v, w, u):
    """Sequential wkv over a chunk.
    state (B,H,N,N); r,k,v,w (B,C,H,N); u (H,N).

    The chunk's kᵀv and diag(u)·kᵀv products, which no step depends on,
    are formed for every step at once; each step then adds, multiplies
    and updates the state (three launches)."""
    kv = k[..., :, None] * v[..., None, :]                   # (B,C,H,N,N)
    ukv = u[..., :, None] * kv
    outs = []
    for r_t, kv_t, ukv_t, w_t in zip(r[..., None, :].unbind(1),
                                     kv.unbind(1), ukv.unbind(1),
                                     w[..., None].unbind(1)):
        outs.append((r_t @ (state + ukv_t))[..., 0, :])
        state = torch.addcmul(kv_t, w_t, state)
    return state, torch.stack(outs, dim=1)                   # (B,C,H,N)


def time_mix(p: Dict, x, *, num_heads: int, head_dim: int,
             chunk: int = 256, norm_eps: float = 1e-5,
             init_state: Optional[Dict] = None, return_state: bool = False):
    B, S, D = x.shape
    H, N = num_heads, head_dim
    h = layer_norm(x, p["ln_w"], p["ln_b"], norm_eps)

    x_prev_last = (init_state["x_prev_tm"] if init_state is not None
                   else h.new_zeros((B, D)))
    hp = _token_shift(h, x_prev_last)
    dx = hp - h

    def mixed(name):
        mu = p[f"mu_{name}"].to(h.dtype)
        lora = _lora(h.float(), p[f"lora_{name}_a"],
                     p[f"lora_{name}_b"]).to(h.dtype)
        return h + dx * (mu + lora)

    def proj(name):
        return torch.einsum("bsd,dhn->bshn", mixed(name),
                            p[f"w_{name}"].to(h.dtype))

    r, k, v, g = proj("r"), proj("k"), proj("v"), proj("g")
    # data-dependent decay (the Finch mechanism)
    wraw = (p["w0"].float()
            + _lora(mixed("w").float(), p["lora_w_a"],
                    p["lora_w_b"]).reshape(B, S, H, N))
    w = torch.exp(-torch.exp(wraw))                          # (B,S,H,N) in (0,1)

    rf, kf, vf = (t.float() for t in (r, k, v))
    u = p["u"].float()                                       # (H,N)
    state = (init_state["wkv"] if init_state is not None
             else torch.zeros((B, H, N, N), dtype=torch.float32,
                              device=x.device))

    if S <= chunk:
        state, out = _wkv_chunk(state, rf, kf, vf, w, u)
    else:
        if S % chunk:
            raise ValueError(f"time_mix: S={S} > chunk={chunk} must be a "
                             f"multiple of it")
        outs = []
        for c0 in range(0, S, chunk):
            part = tuple(t[:, c0:c0 + chunk] for t in (rf, kf, vf, w))
            if torch.is_grad_enabled():
                state, o = checkpoint(_wkv_chunk, state, *part, u,
                                      use_reentrant=False)
            else:
                state, o = _wkv_chunk(state, *part, u)
            outs.append(o)
        out = torch.cat(outs, dim=1)

    # per-head group norm (biased variance), then gate
    mu = torch.mean(out, dim=-1, keepdim=True)
    var = torch.var(out, dim=-1, keepdim=True, correction=0)
    out = (out - mu) * torch.rsqrt(var + norm_eps)
    out = out * p["gn_w"].float() + p["gn_b"].float()
    out = out.to(x.dtype) * F.silu(g.float()).to(x.dtype)
    out = torch.einsum("bshn,hnd->bsd", out, p["w_o"].to(x.dtype))
    res = x + out
    if return_state:
        return res, {"wkv": state, "x_prev_tm": h[:, -1]}
    return res


def channel_mix(p: Dict, x, *, norm_eps: float = 1e-5,
                init_state: Optional[Dict] = None,
                return_state: bool = False):
    B, S, D = x.shape
    h = layer_norm(x, p["ln_w"], p["ln_b"], norm_eps)
    x_prev_last = (init_state["x_prev_cm"] if init_state is not None
                   else h.new_zeros((B, D)))
    hp = _token_shift(h, x_prev_last)
    dx = hp - h
    hk = h + dx * p["mu_k"].to(h.dtype)
    hr = h + dx * p["mu_r"].to(h.dtype)
    kk = torch.einsum("bsd,df->bsf", hk, p["w_k"].to(h.dtype))
    kk = torch.square(torch.relu(kk.float())).to(h.dtype)
    vv = torch.einsum("bsf,fd->bsd", kk, p["w_v"].to(h.dtype))
    rr = torch.sigmoid(
        torch.einsum("bsd,de->bse", hr, p["w_r"].to(h.dtype)).float()
    ).to(h.dtype)
    res = x + rr * vv
    if return_state:
        return res, {"x_prev_cm": h[:, -1]}
    return res


def rwkv_block(p: Dict, x, *, num_heads: int, head_dim: int,
               chunk: int = 256, norm_eps: float = 1e-5,
               init_state: Optional[Dict] = None,
               return_state: bool = False):
    """time_mix then channel_mix; ``return_state`` adds ``{"wkv": (B, H,
    N, N) float32, "x_prev_tm", "x_prev_cm": (B, D)}``."""
    if return_state:
        x, st_tm = time_mix(p["tm"], x, num_heads=num_heads,
                            head_dim=head_dim, chunk=chunk,
                            norm_eps=norm_eps, init_state=init_state,
                            return_state=True)
        x, st_cm = channel_mix(p["cm"], x, norm_eps=norm_eps,
                               init_state=init_state, return_state=True)
        return x, {**st_tm, **st_cm}
    x = time_mix(p["tm"], x, num_heads=num_heads, head_dim=head_dim,
                 chunk=chunk, norm_eps=norm_eps, init_state=init_state)
    return channel_mix(p["cm"], x, norm_eps=norm_eps, init_state=init_state)
