"""The exact-panel X exchange of the sharded fused path and the int8
wire all-reduce (port of ``src/repro/distributed/collectives.py``).

The reference runs the exchange once per chip inside ``shard_map``, as
one ``all_to_all``.  The port is single-controller, so
:func:`exact_panel_exchange` runs the all-to-all for every chip at once:
chip ``dst`` receives, from each chip ``src`` in turn, the owned panels
``send_tbl[src][dst]``, and keeps the received panels its fetch order
names.  Everything it does is a copy (``index_select`` and ``.to``), so
the compact X workspaces are the reference's bit for bit; on chips
that share one device the all-to-all and the fetch compose into one
gather.  :func:`sharded_x` gives each chip its X operand under either
placement.

:func:`compressed_psum` is the int8 gradient all-reduce: each
participant quantises its contribution to int8 with a per-tensor float32
scale (``optim.compression._quantize``, the reference's formula), every
participant gathers all payloads and scales of its group along the axis
to its own device (4x fewer payload bytes than a float32 ring
all-reduce), dequantises and sums them.  As in the reference, nothing in
training calls it.

The model axis's collectives (the Megatron split,
``distributed/model_split.py``): :func:`model_sum` is the all-reduce
of the chips' partial sums, moved to one device and added in chip
order (its backward, autograd's, copies the gradient back to each
chip), and :func:`vocab_max`, :func:`vocab_sumexp` and
:func:`vocab_target` are the reductions a cross-entropy needs over
logits split by vocabulary.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..optim.compression import _quantize
from .sharding import (ChipMesh, LogicalMesh, aligned16, card_copy,
                       place_on_chips)


def exact_panel_exchange(strips, send_tbl: Sequence[torch.Tensor],
                         recv_sel: Sequence[torch.Tensor],
                         mesh: ChipMesh) -> Tuple[torch.Tensor, ...]:
    """Every chip's compact local X workspace (DESIGN.md §7.8).

    strips   : per chip, its ``(P, bk, d)`` owned panel strip (a
               sequence, or the stacked ``(C, P, bk, d)`` tensor); each
               goes to its chip's device
    send_tbl : per chip ``src``, a ``(C, T2)`` integer table of the
               own-local panel ids it sends each chip
    recv_sel : per chip, a ``(T,)`` integer table: the flat ``(C*T2,)``
               receive-buffer index of each local panel, in the chip's
               fetch order
    returns  : per chip, ``(T*bk, d)`` rows on its device, laid out as
               its remapped column stream addresses them

    Chip ``dst``'s receive buffer is ``cat_src(strips[src][send_tbl[src]
    [dst]])`` moved to ``dst``'s device — the reference's
    ``all_to_all(split_axis=0, concat_axis=0)`` — and its workspace is
    ``buffer[recv_sel[dst]]``.  When every chip lies on one device there
    is no wire to cross, and the two steps compose into one gather from
    the owners' strips (:func:`_exchange_one_gather`)."""
    C = mesh.size
    if not len(strips) == len(send_tbl) == len(recv_sel) == C:
        raise ValueError(f"the exchange needs one strip, send table and "
                         f"receive table per chip ({C})")
    if mesh.single_device:
        return _exchange_one_gather(strips, send_tbl, recv_sel,
                                    mesh.devices[0])
    return _exchange_all_to_all(place_on_chips(strips, mesh), send_tbl,
                                recv_sel, mesh)


def _exchange_all_to_all(strips, send_tbl, recv_sel,
                         mesh: ChipMesh) -> Tuple[torch.Tensor, ...]:
    """The exchange as the reference runs it: each chip's receive
    buffer gathered from every source in turn, then its fetch order
    picked from the buffer."""
    out = []
    for dst, dev in enumerate(mesh.devices):
        recv = torch.cat([
            strips[src].index_select(0, send_tbl[src][dst].long()).to(dev)
            for src in range(mesh.size)])              # (C*T2, bk, d)
        panels = recv.index_select(0, recv_sel[dst].long())  # (T, bk, d)
        out.append(panels.reshape(-1, panels.shape[-1]))
    return tuple(out)


def _exchange_one_gather(strips, send_tbl, recv_sel,
                         dev: torch.device) -> Tuple[torch.Tensor, ...]:
    """The exchange on chips that share ``dev``: receive-buffer index
    ``r`` of chip ``dst`` is panel ``send_tbl[r // T2][dst][r % T2]`` of
    source ``r // T2``'s strip, so every chip's workspace is one pick
    from the owners' strips laid end to end, and all chips' picks are
    one ``index_select``.  Each chip's workspace is a view into it."""
    owned = (strips.to(dev).flatten(0, 1)              # a view, no copy
             if isinstance(strips, torch.Tensor)
             else torch.cat([s.to(dev) for s in strips]))
    sizes = torch.tensor([s.shape[0] for s in strips], device=dev)
    starts = torch.cumsum(sizes, 0) - sizes
    send = torch.stack([t.to(dev) for t in send_tbl]).long()  # (C, C, T2)
    T2 = send.shape[-1]
    picks = []
    for dst in range(send.shape[1]):
        r = recv_sel[dst].to(dev).long()
        src = torch.div(r, T2, rounding_mode="floor")
        picks.append(starts[src] + send[src, dst, r % T2])
    panels = owned.index_select(0, torch.cat(picks))    # (sum T, bk, d)
    return tuple(aligned16(p.reshape(-1, p.shape[-1]))
                 for p in panels.split([len(p) for p in picks]))


def sharded_x(x, mesh: ChipMesh, x_sharding: str, x_send, x_recv):
    """Each chip's X operand: ``x`` itself on every chip's device when
    replicated, or — under ``x_sharding="rows"`` — the chip's compact
    workspace from the exact-panel exchange over the stacked ``(C, P,
    bk, d_pad)`` owned strips ``x`` and the ``x_send``/``x_recv``
    tables."""
    if x_sharding == "replicated":
        return tuple(x.to(dev) for dev in mesh.devices)
    if x_sharding != "rows":
        raise ValueError(f"x_sharding must be 'replicated' or 'rows', got "
                         f"{x_sharding!r}")
    if x_send is None or x_recv is None:
        raise ValueError("x_sharding='rows' needs the x_send/x_recv tables")
    return exact_panel_exchange(x, place_on_chips(x_send, mesh),
                                place_on_chips(x_recv, mesh), mesh)


def int8_wire(parts) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each participant's wire: (int8 payload, float32 scale) of its part,
    on its own device."""
    return [_quantize(p.float()) for p in parts]


def compressed_psum(parts, mesh: LogicalMesh, axis: str = "data"
                    ) -> List[torch.Tensor]:
    """All-reduce ``parts`` (one same-shape tensor per chip, on the
    chip's device) over ``axis`` with an int8 wire format.  Returns each
    chip's float32 sum over the chips that differ from it only along
    ``axis``, in the axis's order."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} "
                         f"chips")
    if axis not in mesh.axis_names:
        raise ValueError(f"no axis {axis!r} in {mesh.axis_names}")
    wire = int8_wire(parts)
    coords = [mesh.coords(c) for c in range(mesh.size)]
    out = []
    for chip, dev in enumerate(mesh.devices):
        peers = [c for c in range(mesh.size)
                 if all(coords[c][a] == coords[chip][a]
                        for a in mesh.axis_names if a != axis)]
        qs = torch.stack([wire[c][0].to(dev) for c in peers])    # (n, ...)
        ss = torch.stack([wire[c][1].to(dev) for c in peers])    # (n,)
        deq = qs.float() * ss.reshape((-1,) + (1,) * (qs.ndim - 1))
        out.append(torch.sum(deq, dim=0))
    return out


def wire_bytes_ratio(shape: Tuple[int, ...]) -> float:
    """f32 ring all-reduce payload vs int8 all-gather payload per
    participant."""
    n = float(np.prod(shape))
    f32_ar = 2 * n * 4          # reduce-scatter + all-gather halves
    int8_ag = n * 1 + 4
    return f32_ar / int8_ag


def model_sum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The model-axis all-reduce: each chip's partial moved to
    ``device`` (``card_copy``: from another card on a stream of its own)
    and added in chip order (one part comes back as it is)."""
    out = card_copy(parts[0], device)
    for p in parts[1:]:
        out = out + card_copy(p, device)
    return out


def vocab_max(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The largest logit of each row over the chips' vocabulary shards
    (..., V_m), on ``device``: each chip's max, then the max of those.
    It only shifts the exponentials, so it carries no gradient."""
    out = None
    for s in shards:
        m = card_copy(torch.amax(s.detach(), dim=-1), device)
        out = m if out is None else torch.maximum(out, m)
    return out


def vocab_sumexp(shards: Sequence[torch.Tensor], top: torch.Tensor,
                 device) -> torch.Tensor:
    """Σ exp(logit - top) of each row over every shard: each chip sums
    its own, then the chips' sums add in chip order.  ``top`` goes to
    every chip before the first chip's sum is enqueued."""
    tops = [card_copy(top, s.device) for s in shards]
    return model_sum([torch.sum(torch.exp(s - t[..., None]), dim=-1)
                      for s, t in zip(shards, tops)], device)


def vocab_target(shards: Sequence[torch.Tensor], starts: Sequence[int],
                 labels: torch.Tensor, device) -> torch.Tensor:
    """The logit of each row's label, from the chip whose shard (columns
    ``starts[m]`` on) holds it; the other chips give 0.  The labels go
    to every chip first."""
    parts = []
    taken = [card_copy(labels, s.device) for s in shards]
    for s, lo, lab in zip(shards, starts, taken):
        local = lab.long() - lo
        mine = (local >= 0) & (local < s.shape[-1])
        picked = torch.gather(s, -1, local.clamp(0, s.shape[-1] - 1)[..., None])
        parts.append(torch.where(mine, picked[..., 0],
                                 picked.new_zeros(())))
    return model_sum(parts, device)
