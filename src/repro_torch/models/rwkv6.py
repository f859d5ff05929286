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

Under a model split (``distributed.model_split``, the training forward)
the time-mix runs each model chip on its own heads (``w_[rkvg]``
columns, ``u``/``w0``/``gn_*`` by head, ``w_o`` rows to a partial
output) after the shared token shift and LoRA modulations, which stay
whole and are computed once; the channel-mix sums ``w_v``'s partials
over the chips before the receptance gate, each chip then gating its
own ``w_r`` columns of the sum.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.model_split import ModelSplit
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


def _no_state(split: ModelSplit, init_state, return_state) -> None:
    if split.tp > 1 and (init_state is not None or return_state):
        raise ValueError("the model split runs the training forward: no "
                         "recurrent state in or out")


def time_mix(p: Dict, x, *, num_heads: int, head_dim: int,
             chunk: int = 256, norm_eps: float = 1e-5,
             init_state: Optional[Dict] = None, return_state: bool = False,
             split: Optional[ModelSplit] = None):
    split = split or ModelSplit(x.device)
    _no_state(split, init_state, return_state)
    B, S, D = x.shape
    H, N = num_heads, head_dim
    h = layer_norm(x, split.take(p["ln_w"]), split.take(p["ln_b"]),
                   norm_eps)

    x_prev_last = (init_state["x_prev_tm"] if init_state is not None
                   else h.new_zeros((B, D)))
    hp = _token_shift(h, x_prev_last)
    dx = hp - h

    def mixed(name):
        mu = split.take(p[f"mu_{name}"]).to(h.dtype)
        lora = _lora(h.float(), split.take(p[f"lora_{name}_a"]),
                     split.take(p[f"lora_{name}_b"])).to(h.dtype)
        return h + dx * (mu + lora)

    # data-dependent decay (the Finch mechanism): the LoRA part, whole
    wlora = _lora(mixed("w").float(), split.take(p["lora_w_a"]),
                  split.take(p["lora_w_b"])).reshape(B, S, H, N)
    inputs = {name: mixed(name) for name in ("r", "k", "v", "g")}
    chips = split.chips_for(p["w_r"], 1)

    def take(m):
        heads = [split.owned(p["w_r"], 1, m)]
        lo, hi = heads[0]
        wl = wlora if (lo, hi) == (0, H) else wlora[:, :, lo:hi]
        return (*(split.to(inputs[n], m) for n in ("r", "k", "v", "g")),
                *(split.take(p[f"w_{n}"], m, 1, heads)
                  for n in ("r", "k", "v", "g")),
                split.to(wl, m),
                *(split.take(p[n], m, 0, heads)
                  for n in ("w0", "u", "gn_w", "gn_b", "w_o")))

    def part(m, xr, xk, xv, xg, w_r, w_k, w_v, w_g, wl, w0, u, gn_w, gn_b,
             w_o):
        nonlocal state

        def proj(xm, w):
            return torch.einsum("bsd,dhn->bshn", xm, w.to(h.dtype))

        r, k, v, g = proj(xr, w_r), proj(xk, w_k), proj(xv, w_v), \
            proj(xg, w_g)
        wraw = w0.float() + wl
        w = torch.exp(-torch.exp(wraw))                  # (B,S,Hl,N) in (0,1)

        rf, kf, vf = (t.float() for t in (r, k, v))
        u = u.float()                                    # (Hl,N)
        state = (init_state["wkv"] if init_state is not None
                 else torch.zeros((B, w0.shape[0], N, N), dtype=torch.float32,
                                  device=r.device))

        if S <= chunk:
            state, out = _wkv_chunk(state, rf, kf, vf, w, u)
        else:
            if S % chunk:
                raise ValueError(f"time_mix: S={S} > chunk={chunk} must be "
                                 f"a multiple of it")
            outs = []
            for c0 in range(0, S, chunk):
                piece = tuple(t[:, c0:c0 + chunk] for t in (rf, kf, vf, w))
                if torch.is_grad_enabled():
                    state, o = checkpoint(_wkv_chunk, state, *piece, u,
                                          use_reentrant=False)
                else:
                    state, o = _wkv_chunk(state, *piece, u)
                outs.append(o)
            out = torch.cat(outs, dim=1)

        # per-head group norm (biased variance), then gate
        mu = torch.mean(out, dim=-1, keepdim=True)
        var = torch.var(out, dim=-1, keepdim=True, correction=0)
        out = (out - mu) * torch.rsqrt(var + norm_eps)
        out = out * gn_w.float() + gn_b.float()
        out = out.to(x.dtype) * F.silu(g.float()).to(x.dtype)
        return torch.einsum("bshn,hnd->bsd", out, w_o.to(x.dtype))

    state = None
    parts = split.run(chips, take, part)
    res = x + split.sum(parts)
    if return_state:
        return res, {"wkv": state, "x_prev_tm": h[:, -1]}
    return res


def channel_mix(p: Dict, x, *, norm_eps: float = 1e-5,
                init_state: Optional[Dict] = None,
                return_state: bool = False,
                split: Optional[ModelSplit] = None):
    split = split or ModelSplit(x.device)
    _no_state(split, init_state, return_state)
    B, S, D = x.shape
    h = layer_norm(x, split.take(p["ln_w"]), split.take(p["ln_b"]),
                   norm_eps)
    x_prev_last = (init_state["x_prev_cm"] if init_state is not None
                   else h.new_zeros((B, D)))
    hp = _token_shift(h, x_prev_last)
    dx = hp - h
    hk = h + dx * split.take(p["mu_k"]).to(h.dtype)
    hr = h + dx * split.take(p["mu_r"]).to(h.dtype)

    def take_k(m):
        cols = [split.owned(p["w_k"], 1, m)]
        return (split.to(hk, m), split.take(p["w_k"], m, 1, cols),
                split.take(p["w_v"], m, 0, cols))

    def key_part(m, hkm, w_k, w_v):
        kk = torch.einsum("bsd,df->bsf", hkm, w_k.to(h.dtype))
        kk = torch.square(torch.relu(kk.float())).to(h.dtype)
        return torch.einsum("bsf,fd->bsd", kk, w_v.to(h.dtype))

    vv = split.sum(split.run(split.chips_for(p["w_k"], 1), take_k,
                             key_part))

    # the receptance gate multiplies the summed output: each chip gates
    # its own w_r columns of the sum
    def take_r(m):
        lo, hi = split.owned(p["w_r"], 1, m)
        vm = vv if (lo, hi) == (0, D) else vv[..., lo:hi]
        return (split.to(hr, m), split.take(p["w_r"], m, 1, [(lo, hi)]),
                split.to(vm, m))

    def gate_part(m, hrm, w_r, vm):
        rr = torch.sigmoid(torch.einsum("bsd,de->bse", hrm,
                                        w_r.to(h.dtype)).float()).to(h.dtype)
        return rr * vm

    res = x + split.cat(split.run(split.chips_for(p["w_r"], 1), take_r,
                                  gate_part), -1)
    if return_state:
        return res, {"x_prev_cm": h[:, -1]}
    return res


def rwkv_block(p: Dict, x, *, num_heads: int, head_dim: int,
               chunk: int = 256, norm_eps: float = 1e-5,
               init_state: Optional[Dict] = None,
               return_state: bool = False,
               split: Optional[ModelSplit] = None):
    """time_mix then channel_mix; ``return_state`` adds ``{"wkv": (B, H,
    N, N) float32, "x_prev_tm", "x_prev_cm": (B, D)}``; ``split`` (no
    state) runs both over the model chips."""
    if return_state:
        x, st_tm = time_mix(p["tm"], x, num_heads=num_heads,
                            head_dim=head_dim, chunk=chunk,
                            norm_eps=norm_eps, init_state=init_state,
                            return_state=True, split=split)
        x, st_cm = channel_mix(p["cm"], x, norm_eps=norm_eps,
                               init_state=init_state, return_state=True,
                               split=split)
        return x, {**st_tm, **st_cm}
    x = time_mix(p["tm"], x, num_heads=num_heads, head_dim=head_dim,
                 chunk=chunk, norm_eps=norm_eps, init_state=init_state,
                 split=split)
    return channel_mix(p["cm"], x, norm_eps=norm_eps, init_state=init_state,
                       split=split)
