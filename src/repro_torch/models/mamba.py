"""Mamba-1 selective SSM block, jamba's mamba layers (port of
``src/repro/models/mamba.py``).

The sequence runs in chunks of ``chunk`` steps carrying the (B, d_inner,
state) SSM state from chunk to chunk; within a chunk the linear
recurrence
    h_t = a_t * h_{t-1} + b_t,  a_t = exp(dt_t·A),  b_t = dt_t·B_t⊗x_t
is evaluated by composing the affine pairs (a, b), (a2,b2)∘(a1,b1) =
(a1·a2, a2·b1+b2), in a log-depth (Hillis-Steele) scan over the chunk
axis, where the reference runs ``lax.associative_scan``.  No step
divides: a = exp(dt·A) underflows to 0 within a chunk once
A = -exp(A_log) reaches -N, and a product of underflowed factors stays
0 where a quotient would be inf or NaN.  Decode is the O(1) single-step
update (``_conv_step`` and one affine step).  The scan is plain torch:
the reference computes it outside any Pallas kernel.

Under a model split (``distributed.model_split``, the training forward)
each model chip runs the block on its own ``d_inner`` channels: its
slice of the x half and of the z half of ``in_proj``, its conv, scan
and ``A``/``D``/``dt`` channels, and ``out_proj``'s rows to a partial
output.  ``x_proj`` splits by rows, so the chips' dt/B/C are partial
sums: they add once, inside the block, before the scan.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..distributed.model_split import ModelSplit
from .layers import rms_norm


def _ssm_chunk(h0, a, b):
    """h0 (B,Di,N); a,b (B,C,Di,N) -> (states (B,C,Di,N), h_last)."""
    C = a.shape[1]
    shift = 1
    while shift < C:
        # element t composes the pair ``shift`` steps back into itself
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        a_t, b_t = a[:, shift:], b[:, shift:]
        a = torch.cat([a[:, :shift], a_prev * a_t], dim=1)
        b = torch.cat([b[:, :shift], a_t * b_prev + b_t], dim=1)
        shift *= 2
    states = a * h0[:, None] + b
    return states, states[:, -1]


def _conv_step(conv_buf, x_t, w, bias):
    """Causal depthwise conv decode step. conv_buf (B,K-1,Di), x_t (B,Di)."""
    window = torch.cat([conv_buf, x_t[:, None]], dim=1)       # (B,K,Di)
    y = torch.einsum("bkd,kd->bd", window, w) + bias
    return window[:, 1:], y


def _causal_conv(xp, w, S: int):
    """Depthwise causal conv over the zero-padded stream xp (B, S+K-1,
    Di) with w (K, Di): sum over taps k of xp[:, k:k+S] * w[k], summed in
    float32 and rounded once to xp's dtype (the reference's einsum over
    the (B, S, K, Di) windows, without materialising them)."""
    acc = None
    for k in range(w.shape[0]):
        term = xp[:, k:k + S].float() * w[k].float()
        acc = term if acc is None else acc + term
    return acc.to(xp.dtype)


def mamba_block(p: Dict, x: torch.Tensor, *, state_dim: int,
                conv_width: int, chunk: int = 256, norm_eps: float = 1e-5,
                init_state: Optional[Dict] = None,
                return_state: bool = False,
                split: Optional[ModelSplit] = None):
    """Pre-norm Mamba block: x + out_proj(ssm(conv(in_proj(norm(x))))).

    p: ln (D,), in_proj (D, 2*Di), conv_w (K, Di), conv_b (Di,),
       x_proj (Di, R+2N), dt_proj (R, Di), dt_bias (Di,),
       A_log (Di, N), D (Di,), out_proj (Di, D)

    S > chunk needs S % chunk == 0 (``ValueError``).  A decode step (S =
    1 with ``init_state``) advances the conv buffer; a longer input pads
    with zeros and ignores any incoming conv state, as the reference
    does.  ``return_state`` adds ``{"ssm": (B, Di, N) float32, "conv":
    (B, K-1, Di)}``.  ``split`` (no state) runs the model chips on their
    channels.
    """
    split = split or ModelSplit(x.device)
    if split.tp > 1 and (init_state is not None or return_state):
        raise ValueError("the model split runs the training forward: no "
                         "recurrent state in or out")
    B, S, D = x.shape
    Di = p["in_proj"].shape[1] // 2
    N = state_dim
    R = p["dt_proj"].shape[0]

    h = rms_norm(x, split.take(p["ln"]), norm_eps)
    chips = split.chips_for(p["conv_w"], 1)

    # per chip: its x and z channels, the conv, and its x_proj partial
    def take_in(m):
        lo, hi = split.owned(p["conv_w"], 1, m)
        return (lo, hi, split.to(h, m),
                split.take(p["in_proj"], m, 1, [(lo, hi), (Di + lo, Di + hi)]),
                split.take(p["conv_w"], m, 1, [(lo, hi)]),
                split.take(p["conv_b"], m, 0, [(lo, hi)]),
                split.take(p["x_proj"], m, 0, [(lo, hi)]))

    def conv_part(m, lo, hi, hm, w_in, conv_w, conv_b, x_proj):
        nonlocal conv_buf
        xz = torch.einsum("bsd,de->bse", hm, w_in.to(h.dtype))
        xi, z = torch.chunk(xz, 2, dim=-1)                   # (B,S,Di_m)
        conv_w, conv_b = conv_w.to(xi.dtype), conv_b.to(xi.dtype)

        # causal depthwise conv (width K)
        if init_state is not None and S == 1:
            conv_buf, xc = _conv_step(init_state["conv"], xi[:, 0], conv_w,
                                      conv_b)
            xc = xc[:, None]
        else:
            pad = xi.new_zeros((B, conv_width - 1, hi - lo))
            xp = torch.cat([pad, xi], dim=1)
            xc = _causal_conv(xp, conv_w, S) + conv_b
            # the reference assigns conv_buf twice; the second one stands
            conv_buf = xp[:, -(conv_width - 1):]
        xc = F.silu(xc.float()).to(xi.dtype)
        # input-dependent SSM parameters: a partial sum over channels
        return (torch.einsum("bsd,dr->bsr", xc, x_proj.to(xc.dtype)), xc,
                z)

    conv_buf = None
    firsts = dict(zip(chips, split.run(chips, take_in, conv_part)))
    proj = split.sum([firsts[m][0] for m in chips])
    dt_low, Bm, Cm = torch.split(proj, [R, N, N], dim=-1)

    def take_scan(m):
        cols = [split.owned(p["conv_w"], 1, m)]
        return (*firsts[m][1:], *(split.to(t, m) for t in (dt_low, Bm, Cm)),
                *(split.take(p[n], m, d, cols) for n, d in
                  (("dt_proj", 1), ("dt_bias", 0), ("A_log", 0), ("D", 0),
                   ("out_proj", 0))))

    def scan_part(m, xc, z, dtl, Bc, Cc, dt_proj, dt_bias, A_log, D_m,
                  out_proj):
        nonlocal h_last
        dt = F.softplus(
            torch.einsum("bsr,rd->bsd", dtl, dt_proj.to(xc.dtype)).float()
            + dt_bias.float())
        A = -torch.exp(A_log.float())                        # (Di,N)
        a = torch.exp(dt[..., None] * A)                     # (B,S,Di,N)
        b = (dt[..., None] * Bc[:, :, None, :].float()
             * xc[..., None].float())                        # (B,S,Di,N)

        h0 = (init_state["ssm"] if init_state is not None
              else torch.zeros((B, xc.shape[-1], N), dtype=torch.float32,
                               device=xc.device))

        if S == 1:
            states = a[:, 0] * h0 + b[:, 0]
            y = torch.einsum("bdn,bn->bd", states, Cc[:, 0].float())[:, None]
            h_last = states
        elif S <= chunk:
            states, h_last = _ssm_chunk(h0, a, b)
            y = torch.einsum("bsdn,bsn->bsd", states, Cc.float())
        else:
            if S % chunk:
                raise ValueError(f"mamba_block: S={S} > chunk={chunk} must "
                                 f"be a multiple of it")
            h_last, ys = h0, []
            for c0 in range(0, S, chunk):
                states, h_last = _ssm_chunk(h_last, a[:, c0:c0 + chunk],
                                            b[:, c0:c0 + chunk])
                ys.append(torch.einsum("bsdn,bsn->bsd", states,
                                       Cc[:, c0:c0 + chunk].float()))
                del states
            y = torch.cat(ys, dim=1)

        y = y + xc.float() * D_m.float()
        y = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
        return torch.einsum("bse,ed->bsd", y, out_proj.to(y.dtype))

    h_last = None
    res = x + split.sum(split.run(chips, take_scan, scan_part))
    if return_state:
        return res, {"ssm": h_last, "conv": conv_buf}
    return res
