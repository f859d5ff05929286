"""The model axis computes: the Megatron split of one data group's
forward over its model chips (the counterpart of GSPMD's compute split
under the reference's ``tp`` rules, ``src/repro/distributed/
sharding.py``).

A :class:`ModelSplit` stands for the chips of one data group, one per
model coordinate ``m``.  The stack's blocks ask it, for the leaf that
carries the block's split dim (``wq``'s heads, ``w_gate``'s ``d_ff``
columns, the experts, the vocabulary rows), which chips compute the
block (:meth:`ModelSplit.chips_for`): every model coordinate when the
rules split that dim over ``model``, else one computation on the group's
device (``None``), since a rule that fell back to replication leaves
every model chip the same work, which the port does once.  Chip ``m``
then takes the part of each leaf it needs (:meth:`ModelSplit.take`:
its own block, gathered over the data axis only, or the slice of a
replicated leaf that its part of the block reads), computes its partial
on its own device, and :meth:`ModelSplit.sum` adds the partials in chip
order on the group's device (``collectives.model_sum``).  Without a
mesh the split is one computation over plain tensors, the unsharded
stack's own arithmetic.

A :class:`SplitTally` (``shard_ctx["tally"]``) counts what each chip
gathered and the attention artifact calls it made, and the model-axis
sums; on request it times each sum, and each chip's part of every block
in the forward and in the backward, with CUDA events.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from . import sharding
from .collectives import model_sum

Range = Tuple[int, int]


class SplitTally:
    """Per chip of ``mesh``: the bytes the split gathered for it
    (``gathered``) and the attention artifact calls it made (``attn``);
    the model-axis sums of more than one part (``sums``).  With
    ``timed``, pairs of CUDA events around each such sum (``sum_spans``)
    and a ``timeline`` of CUDA events, in the order the host records
    them, each on its own device's stream: the start and end of each
    chip's part of a block, on the chip's device (a block computed once
    counts on the group's first chip), and in the backward, a mark on
    the gradient's device where the gradient of each leaf part a chip
    took, or of a sum, is complete."""

    def __init__(self, mesh: sharding.LogicalMesh, timed: bool = False):
        self.devices = mesh.devices
        self.gathered = [0] * mesh.size
        self.attn = [0] * mesh.size
        self.sums = 0
        self.timed = timed
        self.sum_spans: List[tuple] = []
        self.timeline: List[tuple] = []

    def sum_ms(self) -> float:
        """The timed sums' milliseconds in all (synchronises)."""
        sharding.synchronize(self.devices)
        return sum(a.elapsed_time(b) for a, b in self.sum_spans)

    def _spans(self):
        """Each span of the timeline a chip owns: ``(kind, chip,
        device, ms)``, pairing an event only with the one before it on
        its own device (synchronises).  The forward's spans run from a
        chip part's start to its device's next event; the backward
        walks the marks: the time up to a mark of chip ``c`` since its
        device's last event is ``c``'s (the autograd engine runs a
        later-made node first, so one chip's part of an attention, FFN
        or head block runs whole before the next's; the recurrent slots'
        chained loops interleave), the time up to a sum's mark or a
        mark taken outside a chip's part is no chip's.  On one device
        that is every event paired with the next."""
        sharding.synchronize(self.devices)
        last = {}
        for kind, chip, ev in self.timeline:
            before = last.get(ev.device)
            last[ev.device] = (kind, chip, ev)
            if before is None:
                continue
            if before[0] == "start":
                yield "forward", before[1], ev.device, \
                    before[2].elapsed_time(ev)
            elif kind == "grad" and chip is not None:
                yield "backward", chip, ev.device, \
                    before[2].elapsed_time(ev)

    def chip_ms(self) -> Tuple[List[float], List[float]]:
        """Each chip's milliseconds (synchronises): ``(forward,
        backward)``.  The forward is its parts' spans, the recompute's
        included; the backward its marks' spans (``_spans``).  The
        loss's own forward and backward count with the head's last
        chip."""
        fwd = [0.0] * len(self.attn)
        bwd = [0.0] * len(self.attn)
        for kind, chip, _, ms in self._spans():
            (fwd if kind == "forward" else bwd)[chip] += ms
        return fwd, bwd

    def card_ms(self) -> dict:
        """Each device's milliseconds inside its chips' spans and the
        sums recorded on it (synchronises)."""
        out = dict.fromkeys(self.devices, 0.0)
        for _, _, dev, ms in self._spans():
            out[dev] += ms
        for a, b in self.sum_spans:
            out[a.device] += a.elapsed_time(b)
        return out


class _Event:
    """A CUDA timing event recorded on ``device``'s current stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.event = torch.cuda.Event(enable_timing=True)
        self.event.record(torch.cuda.current_stream(self.device))

    def elapsed_time(self, later: "_Event") -> float:
        return self.event.elapsed_time(later.event)


_event = _Event


def _merged(ranges: Sequence[Range]) -> List[Range]:
    out: List[Range] = []
    for lo, hi in ranges:
        if out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


class ModelSplit:
    """The model chips of one data group: ``chips[m]`` is the flat index
    of the chip at model coordinate ``m`` (the lowest whose batch-axis
    coordinates, row-major, are ``group``), ``devices[m]`` its device;
    ``device`` is the group's, where the residual stream lives.  With no
    mesh there is one model coordinate and no chip index."""

    def __init__(self, device, mesh: Optional[sharding.LogicalMesh] = None,
                 dp: Sequence[str] = (), group: int = 0,
                 tally: Optional[SplitTally] = None):
        self.device, self.tally = device, tally
        self._body = None           # the chip whose part is running
        if mesh is None:
            self.tp, self.chips, self.devices = 1, (None,), (device,)
            return
        sizes = mesh.sizes
        self.tp = sizes.get("model", 1)
        chips = {}
        for chip in range(mesh.size):
            at = mesh.coords(chip)
            g = 0
            for a in dp:
                g = g * sizes[a] + at[a]
            if g == group:
                chips.setdefault(at.get("model", 0), chip)
        if len(chips) != self.tp:
            raise ValueError(f"no data group {group} on a mesh of "
                             f"{mesh.shape} over {tuple(dp)}")
        self.chips = tuple(chips[m] for m in range(self.tp))
        self.devices = tuple(str(mesh.devices[c]) for c in self.chips)

    @classmethod
    def of(cls, shard_ctx, device) -> "ModelSplit":
        """The split ``shard_ctx`` names (its ``"group"``, default 0), or
        the one computation of an unsharded call."""
        if shard_ctx is None:
            return cls(device)
        return cls(device, shard_ctx["mesh"], tuple(shard_ctx["dp"]),
                   shard_ctx.get("group", 0), shard_ctx.get("tally"))

    def chips_for(self, leaf, dim: int) -> list:
        """The model coordinates that compute a block whose split dim is
        ``leaf``'s ``dim``: all of them when the rules split that dim
        over ``model`` (whole units of it: a head, an expert, a column),
        else ``[None]``, one computation on the group's device.  A leaf
        split over ``model`` on another dim raises."""
        if not sharding.is_sharded(leaf):
            return [None]
        d = sharding.model_dim(leaf.placement, leaf.ndim)
        if d is None:
            return [None]
        if d != dim:
            raise ValueError(f"a leaf of {tuple(leaf.shape)} splits dim {d} "
                             f"over model; its block computes by dim {dim}")
        return list(range(self.tp))

    @staticmethod
    def owned(leaf, dim: int, m) -> Range:
        """The range of ``leaf``'s ``dim`` that model chip ``m`` computes
        (``chips_for``): its own block's (``sharding.owned_range``), or
        all of it for the one computation (``m`` None)."""
        if m is None:
            return 0, leaf.shape[dim]
        return sharding.owned_range(leaf.placement, leaf.shape, m)[dim]

    def chip(self, m) -> int:
        """The flat index of model chip ``m`` (``None``: the group's
        first)."""
        return self.chips[0 if m is None else m]

    def _timed(self) -> bool:
        return self.tally is not None and self.tally.timed

    def _mark(self, t: torch.Tensor, chip) -> torch.Tensor:
        """``t``; under a timed tally, a hook on it appends ``("grad",
        chip, event)`` to the timeline when its gradient is complete.  A
        hook adds no node to the graph, so the backward's arithmetic and
        order are the untimed one's.  A leaf is not marked (its hook
        would outlive the step)."""
        if self._timed() and t.grad_fn is not None:
            timeline = self.tally.timeline
            t.register_hook(
                lambda g: timeline.append(("grad", chip, _event(g.device))))
        return t

    def each(self, chips):
        """The model chips ``chips`` in turn; under a timed tally each
        chip's part, the loop body, is bracketed by CUDA events."""
        timeline = self.tally.timeline if self._timed() else None
        for m in chips:
            self._body = self.chip(m)
            if timeline is not None:
                timeline.append(("start", self._body, _event(self.on(m))))
            yield m
            if timeline is not None:
                timeline.append(("end", self._body, _event(self.on(m))))
            self._body = None

    def on(self, m) -> str:
        """Model chip ``m``'s device (``None``: the group's)."""
        return self.device if m is None else self.devices[m]

    def to(self, t: torch.Tensor, m) -> torch.Tensor:
        return t.to(self.on(m))

    def take(self, leaf, m=None, dim: Optional[int] = None,
             ranges: Sequence[Range] = ()) -> torch.Tensor:
        """``leaf`` on model chip ``m``'s device: whole, or along ``dim``
        the (start, stop) ``ranges``, concatenated in order.  A sharded
        leaf is gathered from the blocks that hold that part (for a
        leaf split over ``model`` on ``dim``, chip ``m``'s own range
        reads its own blocks only); the bytes count on the chip."""
        dev = self.on(m)
        whole = dim is None or _merged(ranges) == [(0, leaf.shape[dim])]
        if not sharding.is_sharded(leaf):
            if not whole:
                leaf = torch.cat([leaf.narrow(dim, lo, hi - lo)
                                  for lo, hi in _merged(ranges)], dim)
            return self._mark(leaf.to(dev), self._body)
        full = [(0, n) for n in leaf.shape]
        if whole:
            parts = [sharding.gather_slice(leaf, full, dev)]
        else:
            parts = [sharding.gather_slice(
                leaf, full[:dim] + [r] + full[dim + 1:], dev)
                for r in _merged(ranges)]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        if self.tally is not None:
            self.tally.gathered[self.chip(m)] += \
                out.numel() * out.element_size()
        return self._mark(out, self._body)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The chips' partials added in chip order on the group's
        device (one part: itself)."""
        if self.tally is None or len(parts) == 1:
            return self._mark(model_sum(parts, self.device), None)
        start = _event(self.device) if self.tally.timed else None
        out = model_sum(parts, self.device)
        if self.tally.timed:
            self.tally.sum_spans.append((start, _event(self.device)))
        self.tally.sums += 1
        return self._mark(out, None)

    def count_attn(self, m, calls: int) -> None:
        """Chip ``m`` made ``calls`` attention artifact calls."""
        if self.tally is not None:
            self.tally.attn[self.chip(m)] += calls


def kv_heads(lo: int, hi: int, group: int) -> Tuple[Range, Optional[list]]:
    """The KV heads that query heads ``lo .. hi - 1`` read under GQA
    (query head ``h`` reads KV head ``h // group``): their range, and
    None when the query heads fall on them in equal consecutive groups
    (so ``gqa_attention`` pairs them as it is), else each query head's
    index into the range."""
    klo, khi = lo // group, (hi - 1) // group + 1
    idx = [h // group - klo for h in range(lo, hi)]
    n, kv = hi - lo, khi - klo
    if n % kv == 0 and idx == [j // (n // kv) for j in range(n)]:
        return (klo, khi), None
    return (klo, khi), idx

