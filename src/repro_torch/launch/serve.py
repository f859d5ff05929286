"""Multi-tenant SpMM serving endpoint and its continuous-batching
scheduler, plus the LM generate driver (port of
``src/repro/launch/serve.py``).

The paper's amortization story (Table IV: codegen ≤ 0.02% of execution)
only materializes if a long-lived endpoint reuses the generated artifact
across requests.  ``SpmmServer`` is that endpoint (DESIGN.md §12):

  * requests are bucketed by padded operand width ``d`` and stacked —
    descriptor tables along a "requests" axis — into ONE fused launch
    per batch (``core.spmm.compile_batched_spmm``: K4 on the card's
    default ``pallas_bcsr``/``dma``, K3 on ``pallas_ell``, K1/K2 under
    ``staging="resident"``);
  * artifacts live in a ``JitCache`` (``GLOBAL_CACHE`` by default) with
    single-flight warmup per tenant fingerprint and hit/miss/eviction
    stats surfaced on every response;
  * host→device input transfer is double-buffered through
    ``data.pipeline.DeviceStage``: pinned memory and a side CUDA stream,
    so the launch of batch k never waits on the packing or copy of
    batch k+1;
  * ``autotune=True`` runs the predict-then-measure search on first
    sight of a structure; batched launches resolve ONE configuration
    from the members' memoized winners (DESIGN.md §14.3);
  * a tenant's ``deadline_s`` hint maps onto the artifact's eviction
    priority (DESIGN.md §14.4).

``SpmmScheduler`` (DESIGN.md §14) is the continuous-batching layer on
top: ``submit()`` enqueues one request and returns a future; a scheduler
loop on an injectable clock and executor re-forms ``(d_bucket,
fingerprint-set)`` batches every tick, with bounded per-tenant queues
(overflow gets an explicit :class:`SpmmRejected`) and deficit-round-robin
fairness.

The request contract is the reference's: ``x`` is a host array, ``y``
comes back as a host array, ``a`` is the port's ``CSRMatrix`` (its
values stay on their device).  The server takes ``device=`` (``None`` =
the card) where the reference takes ``interpret=``.

``generate`` is the LM driver: prefill, then one ``forward_decode`` a
token against the KV caches (``models.transformer``), greedy or sampled
from an explicit ``torch.Generator``.  The reference memoizes a
``jax.jit`` of prefill/decode per model; nothing is traced here, so
there is nothing to memoize.

  # SpMM endpoint smoke (batching + scheduler + cache), on the card:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  # ... or on the CPU, through the kernels' plain versions:
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

  # LM generate driver (--smoke: the reduced config; --device cpu):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --smoke --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.autotune import (TuneConfig, default_candidates,
                             lookup_tune_result, resolve_batch_config)
from ..core.csr import CSRMatrix, random_csr
from ..core.jit_cache import GLOBAL_CACHE, JitCache
from ..core.spmm import (FUSED_BACKENDS, PlanVerificationError,
                         _resolve_backend, _resolve_staging_for,
                         compile_batched_spmm, compile_spmm)
from ..data.pipeline import DeviceStage
from ..kernels.ops import resolve_device, resolve_validate


# -- LM generate driver ------------------------------------------------------

def generate(model, params, prompts: torch.Tensor, *, gen_len: int,
             cache_len: int, image_embeds=None, greedy: bool = True,
             generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
    """prompts (B, S) -> (B, S+gen_len) token ids, on ``device`` (the card
    unless ``"cpu"``).

    The first new token is the argmax of prefill's last logits; each
    later one comes from a decode step, its argmax or, with
    ``greedy=False``, a ``torch.multinomial`` draw from its softmax on
    ``generator`` (default: one seeded 0 on the device, the counterpart
    of the reference's fixed default key).
    """
    device = resolve_device(device)
    prompts = prompts.to(device)
    B, S = prompts.shape
    if not greedy and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    logits, caches = model.prefill(params, prompts, cache_len,
                                   image_embeds=image_embeds, device=device)
    last = torch.argmax(logits[:, -1:], dim=-1)
    out = [prompts.long(), last]
    for pos in range(S, S + gen_len - 1):
        logits, caches = model.decode_step(params, last, caches, pos,
                                           device=device)
        if greedy:
            last = torch.argmax(logits, dim=-1)
        else:
            last = torch.multinomial(torch.softmax(logits[:, 0], dim=-1), 1,
                                     generator=generator)
        out.append(last)
    return torch.cat(out, dim=1)


# -- multi-tenant SpMM endpoint ---------------------------------------------

def d_bucket(d: int) -> int:
    """Serving bucket for the operand width: next power of two, floored
    at 8.  Artifacts are compiled per bucket, so tenants with d=24 and
    d=30 share one cache entry AND one stacked batch; outputs are sliced
    back to the request's own d."""
    if d < 1:
        raise ValueError(f"operand width must be >= 1, got {d}")
    b = 8
    while b < d:
        b *= 2
    return b


def _sla_priority(deadline_s: Optional[float]) -> float:
    """Deadline hint -> cache eviction score (DESIGN.md §14.4): tighter
    deadline, higher score; no hint stays 0.0 == plain LRU.  The floor
    keeps a degenerate deadline from minting an unbounded priority."""
    if deadline_s is None:
        return 0.0
    return 1.0 / max(float(deadline_s), 1e-3)


@dataclasses.dataclass
class SpmmRequest:
    tenant: str
    a: CSRMatrix
    x: np.ndarray                  # (n, d_r) dense operand, host
    # SLA hint: seconds the tenant can tolerate end-to-end.  Not a
    # scheduling deadline (DRR stays the fairness policy) — it maps to
    # the artifact's eviction priority (§14.4).
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class SpmmResponse:
    tenant: str
    y: np.ndarray                  # (m, d_r), host
    cache_hit: bool                # fingerprint was warm on arrival
    batch_size: int                # requests in the fused dispatch
    latency_s: float               # round entry -> this batch done
    cache_stats: dict              # JitCache.stats() at completion
    # continuous-batching metrics (DESIGN.md §14.2) — defaults keep
    # direct SpmmServer.serve() responses unchanged
    queue_wait_s: float = 0.0      # admission -> dispatch, clock units
    queue_wait_ticks: int = 0      # scheduler passes spent queued
    tenant_share: float = 1.0      # tenant's fraction of this batch


class SpmmServer:
    """The multi-tenant batched SpMM endpoint (DESIGN.md §12).

    One server owns one set of dispatch knobs (the batched artifact
    needs a single static configuration), one device and a jit cache —
    by default the process-wide ``GLOBAL_CACHE``.  ``serve`` is
    thread-compatible: concurrent first requests for one structure fall
    into the cache's single-flight gate and pay exactly one build.
    """

    def __init__(self, *, backend: str = "auto",
                 strategy: str = "nnz_split", bm: int = 8, bk: int = 8,
                 mxu_gain: float = 4.0, device: Optional[str] = None,
                 staging: Optional[str] = None, merge_threshold: int = 0,
                 validate: Optional[str] = None,
                 autotune: bool = False, measure=None, top_k: int = 3,
                 max_batch: int = 8, stage_depth: int = 2,
                 cache: Optional[JitCache] = None):
        self.device = resolve_device(device)
        # sharded=True resolution: batching needs the fused descriptor-
        # table path, so "auto" must not fall back to ref on the CPU
        self.backend = _resolve_backend(backend, self.device, sharded=True)
        if self.backend not in FUSED_BACKENDS:
            raise ValueError(
                f"SpmmServer batches through the fused dispatch "
                f"({'/'.join(FUSED_BACKENDS)}), got {self.backend!r}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.strategy = strategy
        self.bm = bm
        self.bk = bk
        self.mxu_gain = mxu_gain
        # admission control for generated plans (DESIGN.md §15): every
        # artifact this server compiles runs the static verifier at this
        # level, so a malformed plan surfaces as a PlanVerificationError
        # at admission — which the scheduler maps to
        # SpmmRejected("invalid_plan") — never as wrong numerics inside
        # a shared batch
        self.validate = resolve_validate(validate, self.device)
        self.staging = _resolve_staging_for(self.backend, staging,
                                            self.device)
        self.merge_threshold = int(merge_threshold)
        self.autotune = bool(autotune)
        self.measure = measure
        # the measured-finalist count the solo warmup searches use; the
        # batched knob resolver peeks with EXACTLY this value or the
        # memoized winners miss (top_k is part of the tune key)
        self.top_k = int(top_k)
        self.max_batch = int(max_batch)
        self.stage_depth = int(stage_depth)
        self.cache = GLOBAL_CACHE if cache is None else cache
        # the candidate grid the solo warmups search — the batched knob
        # resolver must peek with EXACTLY this grid or the keys miss
        self._tune_candidates = default_candidates(
            bm=self.bm, bk=self.bk, mxu_gain=self.mxu_gain,
            staging=self.staging)
        self._fallback_config = TuneConfig(
            strategy=self.strategy, bm=self.bm, bk=self.bk,
            mxu_gain=self.mxu_gain,
            merge_threshold=self.merge_threshold, staging=self.staging)
        self._lock = threading.Lock()
        self._seen: set = set()        # warmed (fingerprint, bucket)
        self._sla: Dict[tuple, float] = {}   # (fp, bucket) -> priority
        self.requests_served = 0
        self.batches_dispatched = 0

    # -- warmup -------------------------------------------------------------
    def _priority_for(self, a: CSRMatrix, b: int,
                      deadline_s: Optional[float]) -> float:
        """Fold this request's deadline hint into the structure's sticky
        SLA score (max-merge, §14.4) and return the result."""
        key = (a.fingerprint, b)
        pri = _sla_priority(deadline_s)
        with self._lock:
            pri = max(pri, self._sla.get(key, 0.0))
            if pri > 0.0:
                self._sla[key] = pri
        return pri

    def warmup(self, a: CSRMatrix, d: int,
               deadline_s: Optional[float] = None):
        """Single-flight warmup for one tenant structure: build (or
        fetch) the solo artifact for (fingerprint, d-bucket).  Safe to
        call from N threads on first sight.  ``deadline_s`` tightens the
        artifact's eviction priority (§14.4); omitting it never loosens
        one already recorded."""
        b = d_bucket(d)
        pri = self._priority_for(a, b, deadline_s)
        compiled = compile_spmm(
            a, b, strategy=self.strategy, backend=self.backend,
            device=self.device, bm=self.bm, bk=self.bk,
            mxu_gain=self.mxu_gain, staging=self.staging,
            merge_threshold=self.merge_threshold, validate=self.validate,
            autotune=self.autotune, measure=self.measure,
            top_k=self.top_k, cache_priority=pri, cache=self.cache)
        with self._lock:
            self._seen.add((a.fingerprint, b))
        return compiled

    def _batch_knobs(self, members: Sequence[SpmmRequest], b: int):
        """The batched dispatch's knob set.  Fixed-knob servers return
        the constructor knobs (batched == solo bit identity holds, §12);
        autotuning servers fold the members' memoized solo winners into
        one configuration plus a per-member CGCM-threshold tuple
        (DESIGN.md §14.3).  Pure cache peeks — never triggers a search."""
        if not self.autotune:
            return self._fallback_config, self.merge_threshold
        results = [lookup_tune_result(
            r.a, b, backend=self.backend, device=self.device,
            candidates=self._tune_candidates, top_k=self.top_k,
            cache=self.cache)
            for r in members]
        cfg = resolve_batch_config(results, self._fallback_config)
        thresholds = tuple(
            res.config.merge_threshold if res is not None
            else self.merge_threshold for res in results)
        return cfg, thresholds

    # -- serving ------------------------------------------------------------
    def serve(self, requests: Sequence[SpmmRequest]
              ) -> List[SpmmResponse]:
        """One serving round; responses come back in request order.

        Requests are grouped by d-bucket (arrival order within a bucket)
        and chunked at ``max_batch``; each multi-request chunk compiles
        or fetches ONE batched artifact and issues ONE fused launch,
        singletons go through their solo artifact.  The packing and the
        host-to-device copy of chunk k+1 run on the
        :class:`~repro_torch.data.pipeline.DeviceStage` worker while
        chunk k launches.
        """
        if not requests:
            return []
        t0 = time.perf_counter()
        hits: List[bool] = []
        for r in requests:
            key = (r.a.fingerprint, d_bucket(r.x.shape[1]))
            with self._lock:
                hits.append(key in self._seen)
            self.warmup(r.a, r.x.shape[1], deadline_s=r.deadline_s)
        buckets: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            buckets.setdefault(d_bucket(r.x.shape[1]), []).append(i)
        chunks: List[tuple] = []
        for b, idxs in sorted(buckets.items()):
            for c0 in range(0, len(idxs), self.max_batch):
                chunks.append((b, idxs[c0:c0 + self.max_batch]))

        def _prep(chunk):
            # host side of one dispatch: fetch/compile the artifact and
            # pack the operand (runs on the stage's worker thread); the
            # values stay on the device and never enter the stage
            b, idxs = chunk
            if len(idxs) == 1:
                r = requests[idxs[0]]
                compiled = self.warmup(r.a, b)
                x = np.zeros((r.x.shape[0], b), np.float32)
                x[:, :np.asarray(r.x).shape[1]] = np.asarray(r.x)
                return idxs, compiled, x
            members = [requests[i] for i in idxs]
            cfg, thresholds = self._batch_knobs(members, b)
            pri = max(self._priority_for(r.a, b, r.deadline_s)
                      for r in members)
            compiled = compile_batched_spmm(
                [r.a for r in members], b, strategy=cfg.strategy,
                backend=self.backend, device=self.device, bm=cfg.bm,
                bk=cfg.bk, mxu_gain=cfg.mxu_gain, staging=cfg.staging,
                merge_threshold=thresholds, validate=self.validate,
                cache_priority=pri, cache=self.cache)
            return idxs, compiled, compiled.stack_inputs(
                [r.x for r in members])

        responses: List[Optional[SpmmResponse]] = [None] * len(requests)
        with DeviceStage((_prep(c) for c in chunks),
                         depth=self.stage_depth,
                         device=self.device) as staged, torch.no_grad():
            for (idxs, compiled, _), (_, _, x_d) in staged:
                vals = [requests[i].a.vals.to(self.device) for i in idxs]
                if len(idxs) == 1:
                    ys = [compiled(vals[0], x_d)]
                else:
                    ys = compiled(vals, x_d)
                ys = [y.cpu().numpy() for y in ys]
                done = time.perf_counter()
                stats = self.cache.stats()
                for j, i in enumerate(idxs):
                    r = requests[i]
                    responses[i] = SpmmResponse(
                        tenant=r.tenant,
                        y=ys[j][:, :np.asarray(r.x).shape[1]],
                        cache_hit=hits[i], batch_size=len(idxs),
                        latency_s=done - t0, cache_stats=stats)
                with self._lock:
                    self.batches_dispatched += 1
                    self.requests_served += len(idxs)
        return responses    # type: ignore[return-value]

    def stats(self) -> dict:
        s = dict(self.cache.stats())
        with self._lock:
            s.update(tenants=len(self._seen),
                     requests_served=self.requests_served,
                     batches_dispatched=self.batches_dispatched)
        return s


# -- continuous batching (DESIGN.md §14) -------------------------------------

@dataclasses.dataclass
class SpmmRejected:
    """Explicit admission-control verdict: the request was NOT served
    and never will be.  Rejection is a response, not an exception — the
    future resolves to this instead of an :class:`SpmmResponse`."""
    tenant: str
    reason: str        # "queue_full" | "shutdown" | "invalid_plan"
    queue_depth: int               # tenant's depth at the decision
    limit: int                     # the configured bound


class SpmmFuture:
    """The handle ``submit`` returns immediately: ``result()`` blocks
    (with optional timeout) until the scheduler resolves it to an
    :class:`SpmmResponse`, an :class:`SpmmRejected`, or re-raises the
    dispatch error.  Thread-safe; resolution is one-shot."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def rejected(self) -> bool:
        return isinstance(self._value, SpmmRejected)

    def _resolve(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None
               ) -> Union[SpmmResponse, SpmmRejected]:
        if not self._event.wait(timeout):
            raise TimeoutError("SpMM request not resolved yet")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclasses.dataclass
class _Queued:
    request: SpmmRequest
    future: SpmmFuture
    seq: int                       # global admission order
    arrival_tick: int              # scheduler ticks completed at submit
    arrival_time: float            # scheduler clock at submit


class ThreadTickLoop:
    """The production executor: one daemon thread calls ``tick()``
    until stopped, parking on an event for ``interval_s`` whenever a
    tick dispatches nothing (``submit`` kicks the event).  On a CUDA
    ``device`` the thread makes it its current device before its first
    tick, so the kernels it launches and the stage it drives land on
    the server's card."""

    def __init__(self, interval_s: float = 0.001,
                 device: Optional[str] = None):
        self.interval_s = float(interval_s)
        self.device = device
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, tick: Callable[[], int]) -> None:
        def _loop():
            if self.device is not None and self.device != "cpu":
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                if tick() == 0:
                    self._wake.wait(self.interval_s)
                    self._wake.clear()
        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="spmm-scheduler")
        self._thread.start()

    def kick(self) -> None:
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None


class SpmmScheduler:
    """Continuous batching over one :class:`SpmmServer` (DESIGN.md §14):
    a standing request queue replaces the caller-assembled
    ``serve([...])`` round.

    * ``submit`` admits or rejects immediately — per-tenant FIFO queues
      bounded at ``max_queue_per_tenant``; overflow resolves the future
      to :class:`SpmmRejected` (§14.1), never a silent drop.
    * ``tick`` is ONE scheduling pass: pick the d-bucket of the globally
      oldest queued request, then fill up to the server's ``max_batch``
      by deficit-round-robin over the tenant rotation (§14.2) and
      dispatch through ``server.serve`` — the same batched single-flight
      path, so responses stay bit-identical to solo dispatch.
    * time and execution are INJECTED: ``clock`` stamps queue-wait
      metrics; ``executor=None`` means the caller ticks, ``"thread"``
      mounts :class:`ThreadTickLoop` on the server's device, and any
      object with ``start(tick)``/``stop()`` (optionally ``kick()``)
      slots in.
    """

    def __init__(self, server: SpmmServer, *,
                 max_queue_per_tenant: int = 16, quantum: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 executor=None):
        if max_queue_per_tenant < 1:
            raise ValueError(f"max_queue_per_tenant must be >= 1, got "
                             f"{max_queue_per_tenant}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.server = server
        self.max_queue_per_tenant = int(max_queue_per_tenant)
        self.quantum = int(quantum)
        self.clock = clock
        self._lock = threading.Lock()      # queue + counter state
        self._tick_lock = threading.Lock()  # serializes dispatches
        self._queues: Dict[str, Deque[_Queued]] = {}
        self._rotation: List[str] = []     # tenants in first-seen order
        self._deficit: Dict[str, float] = {}
        self._rr = 0                       # rotation start, advances/tick
        self._seq = 0
        self._closed = False
        self.ticks = 0
        self.submitted = 0
        self.rejected = 0
        self.dispatched = 0
        if executor == "thread":
            executor = ThreadTickLoop(device=getattr(server, "device", None))
        self.executor = executor
        if executor is not None:
            executor.start(self.tick)

    # -- admission ----------------------------------------------------------
    def submit(self, request: SpmmRequest) -> SpmmFuture:
        """Admit (or reject) one request; returns its future
        immediately.  Malformed widths raise HERE, at the caller."""
        d_bucket(request.x.shape[1])
        fut = SpmmFuture()
        with self._lock:
            self.submitted += 1
            if self._closed:
                self.rejected += 1
                fut._resolve(SpmmRejected(
                    tenant=request.tenant, reason="shutdown",
                    queue_depth=0, limit=self.max_queue_per_tenant))
                return fut
            q = self._queues.get(request.tenant)
            if q is None:
                q = self._queues[request.tenant] = collections.deque()
                self._rotation.append(request.tenant)
                self._deficit[request.tenant] = 0.0
            if len(q) >= self.max_queue_per_tenant:
                self.rejected += 1
                fut._resolve(SpmmRejected(
                    tenant=request.tenant, reason="queue_full",
                    queue_depth=len(q),
                    limit=self.max_queue_per_tenant))
                return fut
            self._seq += 1
            q.append(_Queued(request, fut, self._seq, self.ticks,
                             self.clock()))
        ex = self.executor
        if ex is not None and hasattr(ex, "kick"):
            ex.kick()
        return fut

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    # -- the scheduler loop -------------------------------------------------
    def _form_batch(self) -> List[_Queued]:
        """One DRR pass (§14.2).  The batch bucket is the globally
        oldest head's d-bucket; tenants are visited in rotation order
        starting at ``_rr`` (which advances every tick, so a tenant
        crowded out of a full batch is visited FIRST within
        ``n_tenants`` ticks).  A visited tenant with a matching head
        earns ``quantum`` deficit and spends 1 per dequeued request;
        heads in other buckets keep their deficit.  Only heads dequeue,
        so per-tenant FIFO is structural."""
        with self._lock:
            heads = [(q[0].seq, t) for t, q in self._queues.items() if q]
            self.ticks += 1
            if not heads:
                return []
            _, oldest = min(heads)
            bucket = d_bucket(
                self._queues[oldest][0].request.x.shape[1])
            batch: List[_Queued] = []
            cap = self.server.max_batch
            n = len(self._rotation)
            for i in range(n):
                if len(batch) >= cap:
                    break
                t = self._rotation[(self._rr + i) % n]
                q = self._queues[t]
                if not q:
                    self._deficit[t] = 0.0
                    continue
                if d_bucket(q[0].request.x.shape[1]) != bucket:
                    continue
                self._deficit[t] = min(
                    self._deficit[t] + self.quantum,
                    float(self.quantum * cap))
                while (q and len(batch) < cap
                       and self._deficit[t] >= 1.0
                       and d_bucket(q[0].request.x.shape[1]) == bucket):
                    batch.append(q.popleft())
                    self._deficit[t] -= 1.0
                if not q:
                    self._deficit[t] = 0.0
            self._rr = (self._rr + 1) % max(n, 1)
            return batch

    def _reject_invalid(self, batch: List[_Queued]) -> List[_Queued]:
        """Admission triage after a batch failed plan verification
        (DESIGN.md §15): probe each member's SOLO artifact, resolve the
        culprits to ``SpmmRejected("invalid_plan")``, and return the
        survivors for a re-dispatch."""
        survivors: List[_Queued] = []
        rejected = 0
        for qd in batch:
            r = qd.request
            try:
                self.server.warmup(r.a, r.x.shape[1],
                                   deadline_s=r.deadline_s)
            except PlanVerificationError:
                qd.future._resolve(SpmmRejected(
                    tenant=r.tenant, reason="invalid_plan",
                    queue_depth=0, limit=0))
                rejected += 1
            except BaseException as e:
                qd.future._fail(e)
                rejected += 1
            else:
                survivors.append(qd)
        if rejected:
            with self._lock:
                self.rejected += rejected
        return survivors

    def tick(self) -> int:
        """One scheduling pass: form one batch and dispatch it.  Returns
        the number of requests dispatched (0 = idle tick).  A
        :class:`PlanVerificationError` triages the batch — culprits
        resolve to ``SpmmRejected("invalid_plan")`` and the rest
        re-dispatch this same tick; any other dispatch error resolves
        every member future with the exception — the loop survives, the
        callers see the failure."""
        with self._tick_lock:
            batch = self._form_batch()
            if not batch:
                return 0
            dispatch_tick = self.ticks - 1   # index of this pass
            t_dispatch = self.clock()
            try:
                responses = self.server.serve(
                    [qd.request for qd in batch])
            except PlanVerificationError:
                n_formed = len(batch)
                batch = self._reject_invalid(batch)
                if not batch:
                    return n_formed
                try:
                    responses = self.server.serve(
                        [qd.request for qd in batch])
                except BaseException as e:
                    for qd in batch:
                        qd.future._fail(e)
                    return n_formed
            except BaseException as e:
                for qd in batch:
                    qd.future._fail(e)
                return len(batch)
            counts: Dict[str, int] = {}
            for qd in batch:
                counts[qd.request.tenant] = \
                    counts.get(qd.request.tenant, 0) + 1
            for qd, resp in zip(batch, responses):
                qd.future._resolve(dataclasses.replace(
                    resp,
                    queue_wait_s=max(t_dispatch - qd.arrival_time, 0.0),
                    queue_wait_ticks=dispatch_tick - qd.arrival_tick,
                    tenant_share=counts[qd.request.tenant] / len(batch)))
            with self._lock:
                self.dispatched += len(batch)
            return len(batch)

    # -- lifecycle ----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop admitting, stop the executor, then either drain the
        queue through normal ticks (``drain=True``) or resolve the
        leftovers as shutdown rejections.  Idempotent."""
        with self._lock:
            self._closed = True
        if self.executor is not None:
            self.executor.stop()
            self.executor = None
        if drain:
            while self.tick():
                pass
        with self._lock:
            leftovers = [qd for q in self._queues.values() for qd in q]
            for q in self._queues.values():
                q.clear()
            self.rejected += len(leftovers)
        for qd in leftovers:
            qd.future._resolve(SpmmRejected(
                tenant=qd.request.tenant, reason="shutdown",
                queue_depth=0, limit=self.max_queue_per_tenant))

    def __enter__(self) -> "SpmmScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    def stats(self) -> dict:
        with self._lock:
            return {"ticks": self.ticks, "submitted": self.submitted,
                    "rejected": self.rejected,
                    "dispatched": self.dispatched,
                    "pending": sum(len(q)
                                   for q in self._queues.values()),
                    "tenants": len(self._rotation)}


# -- CLI ---------------------------------------------------------------------

def _smoke_requests(seed: int = 0, device: Optional[str] = None
                    ) -> List[SpmmRequest]:
    """The reference's tiny multi-tenant mix (mixed families, mixed d
    buckets), the same structures, values and operands."""
    rng = np.random.default_rng(seed)
    tenants = [
        ("moe-router", random_csr(48, 64, density=0.08, family="powerlaw",
                                  seed=11, device=device), 20),
        ("gnn-graph", random_csr(64, 48, density=0.06, family="uniform",
                                 seed=12, device=device), 16),
        ("band-attn", random_csr(40, 40, density=0.12, family="banded",
                                 seed=13, device=device), 20),
        ("long-tail", random_csr(56, 72, density=0.05, family="powerlaw",
                                 seed=14, device=device), 36),
    ]
    return [SpmmRequest(tenant=name, a=a,
                        x=rng.standard_normal(
                            (a.shape[1], d)).astype(np.float32))
            for name, a, d in tenants]


def run_spmm_smoke(device: Optional[str] = None) -> int:
    """The serve smoke: two ``serve`` rounds over a tiny multi-tenant
    mix, then the same mix through the continuous-batching scheduler on
    manual ticks.  Round 2 must be all cache hits, every response must
    match the ``ref`` backend at 1e-4, and the scheduler's outputs must
    be bit-identical to the direct round — exit 0 on success."""
    from ..core.spmm import spmm
    device = resolve_device(device)
    server = SpmmServer(device=device, max_batch=4, cache=JitCache())
    requests = _smoke_requests(device=device)
    t0 = time.perf_counter()
    first = server.serve(requests)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = server.serve(requests)
    hot = time.perf_counter() - t0
    if any(r.cache_hit for r in first):
        raise AssertionError("first round must be all cache misses")
    if not all(r.cache_hit for r in second):
        raise AssertionError("second round must be pure cache hits")
    for req, resp in zip(requests, second):
        ref = spmm(req.a, torch.from_numpy(req.x).to(device),
                   backend="ref", device=device, cache=server.cache)
        if not np.allclose(resp.y, ref.cpu().numpy(), atol=1e-4):
            raise AssertionError(f"tenant {req.tenant}: served output "
                                 f"diverges from the ref backend")
    # continuous batching: submit everything, drain on manual ticks —
    # the scheduler forms the same per-bucket chunks, so outputs must be
    # bit-identical
    sched = SpmmScheduler(server, max_queue_per_tenant=8)
    futures = [sched.submit(r) for r in requests]
    sched.close(drain=True)
    for req, fut, direct in zip(requests, futures, second):
        resp = fut.result(timeout=0)
        if not isinstance(resp, SpmmResponse):
            raise AssertionError(f"rejected: {resp}")
        if not np.array_equal(resp.y, direct.y):
            raise AssertionError(
                f"tenant {req.tenant}: scheduler output diverges "
                f"bitwise from the direct serve round")
    cb = sched.stats()
    s = server.stats()
    print(f"[serve] {device}: {s['requests_served']} requests in "
          f"{s['batches_dispatched']} fused dispatches "
          f"(cold {warm * 1e3:.1f} ms, warm {hot * 1e3:.1f} ms)")
    print(f"[serve] cache: {s['entries']} entries, {s['hits']} hits / "
          f"{s['misses']} misses, tenants={s['tenants']}")
    print(f"[serve] scheduler: {cb['dispatched']} dispatched in "
          f"{cb['ticks']} ticks, {cb['rejected']} rejected")
    print("[serve] smoke OK")
    return 0


def _run_lm(args) -> int:
    """The LM driver on ``args.arch`` (``reduced`` under ``--smoke``):
    weights from a seeded generator, prompts from a numpy seed, one
    ``generate`` call, timed on the host clock."""
    from ..configs import get_config, reduced
    from ..models.model import Model
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, size=(args.batch, args.prompt_len)))
    img = None
    if cfg.family == "vlm":
        img = (torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_image_tokens, cfg.d_model)) * 0.02)
            .to(device, getattr(torch, cfg.dtype)))
    t0 = time.perf_counter()
    out = generate(model, params, prompts, gen_len=args.gen,
                   cache_len=args.prompt_len + args.gen + 1,
                   image_embeds=img, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name} on {device}: generated {tuple(out.shape)} in "
          f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s batched)")
    print("[serve] sample:", out[0, -args.gen:].tolist())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The SpMM serving endpoint's smoke run, or the LM "
                    "generate driver with --arch.")
    ap.add_argument("--arch", default=None,
                    help="LM generate driver for this arch; omit to run "
                         "the SpMM endpoint smoke")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)
    if args.arch is not None:
        return _run_lm(args)
    if not args.smoke:
        ap.error("pass --arch for the LM driver or --smoke for the SpMM "
                 "endpoint smoke")
    return run_spmm_smoke(args.device)


if __name__ == "__main__":
    raise SystemExit(main())
