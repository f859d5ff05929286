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
every model chip the same work, which the port does once.  A block
runs through :meth:`ModelSplit.run` in two phases.  First every chip
takes what it needs: the part of each leaf (:meth:`ModelSplit.take`:
its own block, gathered over the data axis only, or the slice of a
replicated leaf that its part of the block reads) and its inputs
(:meth:`ModelSplit.to`), each through a node of its own (a copy between
cards on a stream of its own, ``sharding.card_copy``; a view on the
chip's own card).  Then each chip computes its partial on its own
device, and :meth:`ModelSplit.sum` adds the partials in chip order on
the group's device (``collectives.model_sum``).  So no take waits
behind another chip's part, the backward (later-made nodes first) runs
every chip's part before any take's copy back, and each chip's gradient
of an input adds as one term whatever card the chip lies on.  Without a
mesh the split is one computation over plain tensors, the unsharded
stack's own arithmetic.

A :class:`SplitTally` (``shard_ctx["tally"]``) counts what each chip
gathered and the attention artifact calls it made, and the model-axis
sums; on request it times each sum, and each chip's part of every block
in the forward and in the backward, with CUDA events, on a clock
common to the cards (:meth:`SplitTally.intervals`).
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
    counts on the group's first chip); in the backward, a ``"back"``
    mark where the gradient of a chip's part output is complete (its
    part's backward begins), and a ``"grad"`` mark where the gradient of
    each leaf part or input a chip took, or of a sum, is complete."""

    def __init__(self, mesh: sharding.LogicalMesh, timed: bool = False):
        self.devices = mesh.devices
        self.gathered = [0] * mesh.size
        self.attn = [0] * mesh.size
        self.sums = 0
        self.timed = timed
        self.sum_spans: List[tuple] = []
        self.timeline: List[tuple] = []
        self.zero: dict = {}

    def begin(self) -> None:
        """Synchronise the mesh's devices and record an event on each:
        the common origin of :meth:`intervals` (each device idle, so
        its event completes when the host records it)."""
        sharding.synchronize(self.devices)
        self.zero = {d: _event(d) for d in dict.fromkeys(self.devices)}

    def sum_ms(self) -> float:
        """The timed sums' milliseconds in all (synchronises)."""
        sharding.synchronize(self.devices)
        return sum(a.elapsed_time(b) for a, b in self.sum_spans)

    def _spans(self):
        """Each span of the timeline a chip owns: ``(kind, chip, device,
        start event, end event)``, pairing an event only with the one
        before it on its own device (synchronises).  A span from a
        part's start is that chip's forward (the recompute's included).
        In the backward a device runs one chip's part from the chip's
        ``"back"`` mark to its next ``"grad"`` mark (the chip's takes,
        which the backward reaches after every part): each span in
        between not from a start is that chip's backward; the spans up
        to a sum's or a take's mark are no chip's.  On one device that is
        every event paired with the next."""
        sharding.synchronize(self.devices)
        last, owner = {}, {}
        for kind, chip, ev in self.timeline:
            before = last.get(ev.device)
            last[ev.device] = (kind, chip, ev)
            if before is not None:
                if before[0] == "start":
                    yield "forward", before[1], ev.device, before[2], ev
                elif owner.get(ev.device) is not None:
                    yield "backward", owner[ev.device], ev.device, \
                        before[2], ev
            if kind == "back":
                owner[ev.device] = chip
            elif kind == "grad":
                owner[ev.device] = None

    def chip_ms(self) -> Tuple[List[float], List[float]]:
        """Each chip's milliseconds (synchronises): ``(forward,
        backward)``.  The forward is its parts' spans, the recompute's
        included; the backward its parts' backward spans (``_spans``).
        The loss's own forward and backward count with the head's
        chips."""
        fwd = [0.0] * len(self.attn)
        bwd = [0.0] * len(self.attn)
        for kind, chip, _, a, b in self._spans():
            (fwd if kind == "forward" else bwd)[chip] += a.elapsed_time(b)
        return fwd, bwd

    def card_ms(self) -> dict:
        """Each device's milliseconds inside its chips' spans and the
        sums recorded on it (synchronises)."""
        out = dict.fromkeys(self.devices, 0.0)
        for _, _, dev, a, b in self._spans():
            out[dev] += a.elapsed_time(b)
        for a, b in self.sum_spans:
            out[a.device] += a.elapsed_time(b)
        return out

    def intervals(self, chips=None, kind=None) -> List[Tuple[float, float]]:
        """The spans of ``chips`` (default all) of ``kind`` (``"forward"``,
        ``"backward"`` or both) as (start, end) milliseconds since their
        device's :meth:`begin` event, merged where they meet: a common
        clock for the devices (synchronises)."""
        out = []
        for k, chip, dev, a, b in self._spans():
            if (chips is None or chip in chips) and kind in (None, k):
                z = self.zero[dev]
                out.append((z.elapsed_time(a), z.elapsed_time(b)))
        return _union(out)


def _union(spans) -> List[Tuple[float, float]]:
    """(start, end) spans merged where they overlap or meet, in order."""
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def busy(spans) -> float:
    """The milliseconds merged ``spans`` cover."""
    return sum(hi - lo for lo, hi in spans)


def overlap(a, b) -> float:
    """The milliseconds during which a span of merged ``a`` and one of
    merged ``b`` run at once."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
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


def reach(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` through a node of its own: a copy from another
    device (``sharding.card_copy``), a view where it lies there.  Each
    chip's use of a tensor then sends its gradient back as one term, and
    the term arrives when that node's backward runs, whichever device
    the chip is on."""
    out = sharding.card_copy(t, device)
    return out.view_as(out) if out is t else out


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
    mesh there is one model coordinate and no chip index.  ``ready``
    (``sharding.written``, a step's start) is when the leaves' blocks
    were last written: a gather from another card waits for it only."""

    def __init__(self, device, mesh: Optional[sharding.LogicalMesh] = None,
                 dp: Sequence[str] = (), group: int = 0,
                 tally: Optional[SplitTally] = None,
                 ready: Optional[dict] = None):
        self.device, self.tally, self.ready = device, tally, ready
        self._body = None           # the chip whose inputs or part run
        self._in_part = False
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
        """The split ``shard_ctx`` names (its ``"group"``, default 0, and
        ``"ready"``), or the one computation of an unsharded call."""
        if shard_ctx is None:
            return cls(device)
        return cls(device, shard_ctx["mesh"], tuple(shard_ctx["dp"]),
                   shard_ctx.get("group", 0), shard_ctx.get("tally"),
                   shard_ctx.get("ready"))

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

    def _mark(self, t, chip, kind: str = "grad"):
        """``t`` (a tensor, or a tuple of them: each); under a timed
        tally, a hook on it appends ``(kind, chip, event)`` to the
        timeline when its gradient is complete.  A hook adds no node to
        the graph, so the backward's arithmetic and order are the untimed
        one's.  A leaf is not marked (its hook would outlive the
        step)."""
        if not self._timed():
            return t
        timeline = self.tally.timeline
        for x in (t if isinstance(t, tuple) else (t,)):
            if isinstance(x, torch.Tensor) and x.grad_fn is not None:
                x.register_hook(lambda g: timeline.append(
                    (kind, chip, _event(g.device))))
        return t

    def run(self, chips, take, part) -> list:
        """The model chips ``chips``' parts of a block: first every
        chip's inputs and weights, ``take(m)`` (a tuple, each tensor
        through a node of its own: :meth:`take`, :meth:`to`), then each
        chip's ``part(m, *taken)`` in turn on its own device.  So the
        takes are enqueued before the first part (a copy to chip ``m``
        waits behind no other chip's part), and the backward, which runs
        later-made nodes first, runs every chip's part before any take
        (a copy back to the group's card waits behind no part).  Returns
        the parts' outputs in chip order.  Under a timed tally each part
        is bracketed by CUDA events and its outputs marked ``"back"``."""
        taken = []
        for m in chips:
            self._body = self.chip(m)
            taken.append(take(m))
        timeline = self.tally.timeline if self._timed() else None
        outs = []
        for m, args in zip(chips, taken):
            self._body = self.chip(m)
            if timeline is not None:
                timeline.append(("start", self._body, _event(self.on(m))))
            self._in_part = True
            try:
                out = part(m, *args)
            finally:
                self._in_part = False
            if timeline is not None:
                timeline.append(("end", self._body, _event(self.on(m))))
            outs.append(self._mark(out, self._body, "back"))
        self._body = None
        return outs

    def on(self, m) -> str:
        """Model chip ``m``'s device (``None``: the group's)."""
        return self.device if m is None else self.devices[m]

    def _taking(self) -> None:
        if self._in_part:
            raise RuntimeError("a chip's inputs are taken ahead of the "
                               "first chip's part (ModelSplit.run's take)")

    def to(self, t: torch.Tensor, m) -> torch.Tensor:
        """``t`` on model chip ``m``'s device; with more than one model
        chip through a node of its own (:func:`reach`)."""
        self._taking()
        if self.tp == 1:
            return t.to(self.on(m))
        return self._mark(reach(t, self.on(m)), self._body)

    def take(self, leaf, m=None, dim: Optional[int] = None,
             ranges: Sequence[Range] = ()) -> torch.Tensor:
        """``leaf`` on model chip ``m``'s device: whole, or along ``dim``
        the (start, stop) ``ranges``, concatenated in order.  A sharded
        leaf is gathered from the blocks that hold that part (for a
        leaf split over ``model`` on ``dim``, chip ``m``'s own range
        reads its own blocks only; a block on another card is copied on
        a stream of its own, after ``ready``); the bytes count on the
        chip.  With more than one model chip every take is a node of its
        own (a block read whole where it lies comes back as a view)."""
        self._taking()
        dev = self.on(m)
        whole = dim is None or _merged(ranges) == [(0, leaf.shape[dim])]
        if not sharding.is_sharded(leaf):
            if not whole:
                leaf = torch.cat([leaf.narrow(dim, lo, hi - lo)
                                  for lo, hi in _merged(ranges)], dim)
            out = leaf.to(dev) if self.tp == 1 else reach(leaf, dev)
            return self._mark(out, self._body)
        full = [(0, n) for n in leaf.shape]
        if whole:
            parts = [sharding.gather_slice(leaf, full, dev, self.ready)]
        else:
            parts = [sharding.gather_slice(
                leaf, full[:dim] + [r] + full[dim + 1:], dev, self.ready)
                for r in _merged(ranges)]
        out = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        if self.tp > 1 and any(out is b for b in leaf.blocks):
            out = out.view_as(out)
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

    def cat(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The chips' parts moved to the group's device and concatenated
        along ``dim`` in chip order (one part: itself)."""
        moved = [sharding.card_copy(p, self.device) for p in parts]
        out = moved[0] if len(moved) == 1 else torch.cat(moved, dim)
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

