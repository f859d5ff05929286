"""The jit-function cache — paper §IV-A / Table IV.

The paper generates assembly once per SpMM instance and reuses it for
subsequent calls; the generation cost is the "codegen overhead" of
Table IV (≤0.02% of execution).  Here the generated artifact is a
``CompiledSpmm``: the plan (segments, tilings, gather maps) plus the
fused-workspace constants already materialized as device arrays, closed
over by a jit-compiled callable.  The cache key is everything the
specialization depends on — structure fingerprint, d, dtype, strategy,
backend, interpret — and explicitly NOT the values (same semantics as
the paper's jit-function, which reloads values from memory on every
call).

``GLOBAL_CACHE`` sits on the serving path and is shared across request
threads, so ``get_or_build`` is thread-safe with single-flight builds:
concurrent requests for the same key block on one builder instead of
racing N redundant (and expensive) plan+lower passes.

The cache is capacity-bounded with LRU eviction (``capacity=None`` =
unbounded, the pre-existing behavior): the autotuner memoizes search
results and every candidate artifact it measured, so a long-lived
serving process would otherwise grow without bound.  ``stats()``
reports hits/misses/evictions for the serving tier.

Eviction is SLA-aware (DESIGN.md §14.4): every entry carries a
``priority`` (default 0.0) and the victim is the least-recently-used
entry *among the lowest-priority class* — plain LRU when every entry is
at the default, but an artifact protected by a tenant's tight deadline
hint (the serving tier maps ``deadline_s`` to ``1/deadline``) outlives
colder entries even when it was touched less recently.  Priorities only
reorder who dies first; they never exempt an entry from the capacity
bound, so a cache full of protected artifacts still evicts (the
least-protected first) instead of growing without bound.

Port of ``src/repro/core/jit_cache.py``, copied with its lock
discipline.  In the port the key carries the resolved ``device`` where
the reference carries ``interpret``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Optional, Tuple

Key = Tuple


def mesh_fingerprint(mesh) -> Optional[Tuple]:
    """Hashable cache-key component for an optional device mesh.

    The port is single-device until the sharded slice lands, so every
    artifact is unsharded and this stays ``None`` — the same value the
    reference keys its single-chip artifacts with.
    """
    return None


@dataclasses.dataclass
class CacheEntry:
    value: Any
    build_seconds: float
    hits: int = 0
    # SLA eviction score (DESIGN.md §14.4): higher survives longer.
    # Monotone — repeated get_or_build calls take the max, so a tenant
    # tightening its deadline upgrades the artifact but a later relaxed
    # request never downgrades protection someone else relies on.
    priority: float = 0.0


class JitCache:
    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, "
                             f"got {capacity}")
        self.capacity = capacity
        self._entries: "collections.OrderedDict[Key, CacheEntry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._inflight: dict = {}
        # bumped by clear(): a builder that claimed its key under an
        # older generation must not insert its (now invalidated)
        # artifact after the clear — see get_or_build / clear
        self._generation = 0
        self.misses = 0
        self.hits = 0
        self.evictions = 0

    def get_or_build(self, key: Key, builder: Callable[[], Any], *,
                     priority: float = 0.0) -> Any:
        """Return the cached value for ``key``, building it at most once
        even under concurrent callers (single-flight).  Waiters of a
        successful build count as hits; if the builder raises, exactly
        one waiter at a time retries.

        ``priority`` is the entry's SLA eviction score (DESIGN.md
        §14.4): 0.0 (the default) is plain LRU; higher values survive
        lower ones when the capacity bound forces an eviction.  Hits
        merge with max, so protection only ever ratchets up."""
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    ent.hits += 1
                    self.hits += 1
                    ent.priority = max(ent.priority, priority)
                    self._entries.move_to_end(key)
                    return ent.value
                event = self._inflight.get(key)
                if event is None:
                    event = threading.Event()
                    self._inflight[key] = event
                    gen = self._generation
                    self.misses += 1
                    we_build = True
                else:
                    we_build = False
            if not we_build:
                # builder in flight on another thread: wait, then re-check
                # (re-loop handles the builder-raised case)
                event.wait()
                continue
            t0 = time.perf_counter()
            try:
                value = builder()
            except BaseException:
                with self._lock:
                    if self._inflight.get(key) is event:
                        self._inflight.pop(key)
                event.set()
                raise
            with self._lock:
                if self._generation == gen:
                    self._entries[key] = CacheEntry(
                        value, time.perf_counter() - t0,
                        priority=priority)
                    self._entries.move_to_end(key)
                    while (self.capacity is not None
                           and len(self._entries) > self.capacity):
                        self._evict_one_locked()
                # else: clear() ran mid-build — the artifact was built
                # against invalidated state, so hand it to OUR caller
                # (who asked before the clear) but never cache it.
                # The identity guard keeps a stale builder from popping
                # a NEWER build's inflight event for the same key.
                if self._inflight.get(key) is event:
                    self._inflight.pop(key)
            event.set()
            return value

    def _evict_one_locked(self) -> None:
        """Drop ONE entry: the least-recently-used member of the
        lowest-priority class.  OrderedDict order IS recency order, so
        the first entry at the minimum priority is the victim — plain
        LRU when priorities are uniform (the pre-SLA behavior, pinned
        by the test_autotune LRU suite)."""
        lowest = min(e.priority for e in self._entries.values())
        for key, ent in self._entries.items():
            if ent.priority == lowest:
                del self._entries[key]
                self.evictions += 1
                return

    def peek(self, key: Key) -> Optional[Any]:
        """Return the cached value without building, counting a hit, or
        touching recency — the read the batched-autotune knob resolver
        uses to consult members' memoized TuneResults (DESIGN.md §14.3)
        without perturbing eviction order."""
        with self._lock:
            ent = self._entries.get(key)
            return None if ent is None else ent.value

    def prioritize(self, key: Key, priority: float) -> bool:
        """Raise an existing entry's eviction priority (max-merge);
        returns False when the key is absent.  The serving tier calls
        this when a tenant's deadline hint tightens after its artifact
        was already built."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return False
            ent.priority = max(ent.priority, priority)
            return True

    def build_seconds(self, key: Key) -> Optional[float]:
        with self._lock:
            ent = self._entries.get(key)
            return None if ent is None else ent.build_seconds

    @property
    def total_build_seconds(self) -> float:
        with self._lock:
            return sum(e.build_seconds for e in self._entries.values())

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "capacity": self.capacity,
                    "total_build_seconds": sum(
                        e.build_seconds for e in self._entries.values())}

    def clear(self):
        """Drop every entry AND invalidate in-flight builds.

        Without the invalidation a builder that claimed its key before
        the clear would re-insert its artifact afterwards, resurrecting
        a stale plan in a long-lived serving process.  Bumping the
        generation makes pre-clear builders skip the insert (their own
        caller still gets the value — it asked before the clear), and
        swapping the inflight map lets post-clear callers start a fresh
        single-flight build immediately instead of adopting the stale
        one; the abandoned events are still set by their builders, so
        their waiters re-loop onto the new map.
        """
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0
            self._generation += 1
            self._inflight = {}


GLOBAL_CACHE = JitCache()


def clear_global_cache():
    GLOBAL_CACHE.clear()
