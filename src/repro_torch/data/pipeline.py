"""Deterministic, offset-addressable token pipeline and the serving
tier's async host-to-device input stage (port of
``src/repro/data/pipeline.py``).

``TokenPipeline`` is the reference's, copied: numpy, a pure function of
(seed, step, host), so a restart at step k reproduces exactly the
batches k, k+1, ... without replaying (the data-side half of
checkpoint/restart), and both packages give the same batches.  Sources:
a synthetic LM stream (zipf-ish unigram mixture with repeated motifs, so
the loss falls) or a memory-mapped int32 token file.

``DeviceStage``: a bounded look-ahead thread packs batch k+1 and copies
it to the device while the consumer dispatches batch k (DESIGN.md §12).
On the card the copy runs on the stage's own CUDA stream from pinned
host memory, so it can overlap the kernels the consumer launches on its
stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..kernels.ops import resolve_device


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    token_file: Optional[str] = None     # memmap int32 tokens, else synthetic
    num_image_tokens: int = 0            # vlm stub frontend
    d_model: int = 0


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, *, host_index: int = 0,
                 host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count
        self._tokens = None
        if cfg.token_file:
            self._tokens = np.memmap(cfg.token_file, dtype=np.int32,
                                     mode="r")
            # batch_at samples (seq_len + 1)-token windows from
            # rng.integers(0, len - seq_len - 1)
            if len(self._tokens) < cfg.seq_len + 2:
                raise ValueError(
                    f"token_file {cfg.token_file!r} has "
                    f"{len(self._tokens)} tokens — too short for "
                    f"seq_len={cfg.seq_len} (need >= {cfg.seq_len + 2} "
                    f"so at least one sample window exists)")

    # -- pure function of (seed, step, host) --------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_index]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        if self._tokens is not None:
            n = len(self._tokens) - cfg.seq_len - 1
            starts = rng.integers(0, n, size=self.local_batch)
            tok = np.stack([self._tokens[s:s + cfg.seq_len + 1]
                            for s in starts]).astype(np.int32)
        else:
            # synthetic: mixture of a zipf unigram stream and short
            # repeated motifs (gives structure a model can learn)
            zipf = rng.zipf(1.3, size=(self.local_batch, cfg.seq_len + 1))
            tok = (zipf % (cfg.vocab_size - 2)).astype(np.int32) + 2
            motif_len = 8
            motif = rng.integers(2, cfg.vocab_size,
                                 size=(self.local_batch, motif_len))
            for rep in range(1, (cfg.seq_len + 1) // (2 * motif_len), 2):
                sl = slice(rep * motif_len, (rep + 1) * motif_len)
                tok[:, sl] = motif
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        if cfg.num_image_tokens:
            batch["image_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.num_image_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Resume mid-stream (restart path)."""
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class _Staged:
    """What the default CUDA transfer hands the consumer: the item's
    arrays as device tensors (``tree``), the event recorded on the side
    stream after their copies, the device tensors themselves, and the
    pinned host sources, referenced until the consumer has waited."""
    tree: Any
    event: torch.cuda.Event
    tensors: List[torch.Tensor]
    pinned: List[torch.Tensor]


class DeviceStage:
    """Async double-buffered host→device input stage (DESIGN.md §12).

    Wraps an iterable of host-side items: a daemon thread pulls the
    source and runs ``transfer`` up to ``depth`` items ahead of the
    consumer, so the dispatch of batch k overlaps the transfer (and the
    host-side packing, since the source is pulled on the worker too) of
    batch k+1.  Iterating yields ``(item, staged)`` pairs in input
    order; an exception raised by the source or the transfer re-raises
    at the consumer's next pull.

    ``transfer=None`` moves every numpy array in the item — nested in
    tuples, lists and dicts; other leaves pass through —
    to ``device`` (``None`` = the card, raising without one, as
    ``resolve_device`` does).  On the CPU each array becomes a tensor.
    On a CUDA device the worker copies each array into pinned memory
    and issues a ``non_blocking`` copy on the stage's own
    ``torch.cuda.Stream``, then records an event; before an item is
    yielded, the consumer's current stream waits on that event and each
    staged tensor is ``record_stream``-ed onto it, so the allocator
    never hands its memory to the side stream while the consumer's
    kernels read it.  The worker runs under ``torch.cuda.device`` of the
    stage's device.  A caller-supplied ``transfer`` is called as it is,
    and ``device`` is then unused.

    The stage owns a thread, so it has a lifecycle: ``close()`` (or the
    context manager) stops the look-ahead and joins the worker.  Every
    ``put`` is close-aware (bounded wait, re-checked against the close
    flag), so close always wins, and ``close`` drains the queue so a
    blocked worker can finish and be joined.
    """

    _DONE = object()

    def __init__(self, items, *, depth: int = 2, transfer=None,
                 device: Optional[str] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = None
        self._stream = None
        if transfer is None:
            self.device = resolve_device(device)
            transfer = self._to_device
            if self.device != "cpu":
                self._stream = torch.cuda.Stream(device=self.device)
        self._transfer = transfer
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iter(items),), daemon=True,
            name="device-stage")
        self._thread.start()

    # -- the default transfer ------------------------------------------------
    def _to_device(self, item):
        if self._stream is None:
            return self._map(item, lambda t: t)
        pinned: List[torch.Tensor] = []
        tensors: List[torch.Tensor] = []

        def copy(host: torch.Tensor) -> torch.Tensor:
            host = host.pin_memory()
            pinned.append(host)
            with torch.cuda.stream(self._stream):
                out = host.to(self.device, non_blocking=True)
            tensors.append(out)
            return out

        tree = self._map(item, copy)
        event = torch.cuda.Event()
        event.record(self._stream)
        return _Staged(tree, event, tensors, pinned)

    def _map(self, obj, move):
        """``obj`` with each numpy array leaf replaced by ``move`` of it
        as a CPU tensor."""
        if isinstance(obj, np.ndarray):
            return move(torch.from_numpy(np.ascontiguousarray(obj)))
        if isinstance(obj, (tuple, list)):
            return type(obj)(self._map(v, move) for v in obj)
        if isinstance(obj, dict):
            return {k: self._map(v, move) for k, v in obj.items()}
        return obj

    def _device_scope(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    # -- the worker -----------------------------------------------------------
    def _put(self, obj) -> bool:
        """Close-aware put: blocks like ``Queue.put`` but gives up as
        soon as the stage is closed.  Returns False when the item was
        dropped because of a close."""
        while not self._closed.is_set():
            try:
                self._q.put(obj, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, it):
        try:
            with self._device_scope():
                for item in it:
                    if self._closed.is_set():
                        return
                    if not self._put((item, self._transfer(item))):
                        return
            self._put(self._DONE)
        except BaseException as e:      # surfaces at the consumer
            self._put(e)

    def close(self) -> None:
        """Stop the look-ahead and join the worker.  Idempotent; safe
        whether iteration finished, was abandoned, or never started.
        Items already staged are discarded."""
        self._closed.set()
        # drain so a worker mid-put (bounded queue full) can observe
        # the flag and exit instead of spinning until the timeout
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()

    def __enter__(self) -> "DeviceStage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self):
        while True:
            if self._closed.is_set():
                return
            got = self._q.get()
            if got is self._DONE:
                return
            if isinstance(got, BaseException):
                raise got
            item, staged = got
            if isinstance(staged, _Staged):
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(staged.event)
                for t in staged.tensors:
                    t.record_stream(stream)
                staged = staged.tree
            yield item, staged
