"""The port's continuous-batching scheduler (``launch/serve.py``) on
``tests/harness.py``'s deterministic harness — fake clock, inline ticks,
no sleeps — as ``tests/test_serve_scheduler.py`` runs the reference's.

The pure scheduling properties run against a stub server at Python
speed, and beside the reference's scheduler on the same arrival script:
the same batch compositions tick by tick and the same rejections.  The
dispatch-path tests use the port's ``SpmmServer`` on ``device="cpu"``
(the kernels' plain versions); one scripted trace runs through both
packages' real servers and schedulers, outputs held at 1e-5.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from harness import FakeClock, InlineExecutor, TraceEvent, drive_trace
from repro.core import csr as ref_csr
from repro.core.jit_cache import JitCache as RefJitCache
from repro.launch import serve as ref_serve
from repro_torch.core import CSRMatrix, random_csr, spmm
from repro_torch.core.autotune import (TuneConfig, lookup_tune_result,
                                       resolve_batch_config)
from repro_torch.core.jit_cache import JitCache
from repro_torch.core.spmm import PlanVerificationError
from repro_torch.launch.serve import (SpmmRejected, SpmmRequest,
                                      SpmmResponse, SpmmScheduler,
                                      SpmmServer, ThreadTickLoop, d_bucket)


class StubServer:
    """The scheduler's server contract (``serve`` + ``max_batch``)
    without kernels: records every dispatched batch, echoes responses in
    the given package's response type."""

    def __init__(self, max_batch: int = 4, response=SpmmResponse):
        self.max_batch = max_batch
        self.response = response
        self.batches = []

    def serve(self, requests):
        self.batches.append(list(requests))
        return [self.response(tenant=r.tenant,
                              y=np.zeros((1, 1), np.float32),
                              cache_hit=True, batch_size=len(requests),
                              latency_s=0.0, cache_stats={})
                for r in requests]


def _req(tenant: str, d: int = 12, request=SpmmRequest):
    return request(tenant=tenant, a=None, x=np.zeros((2, d), np.float32))


def _run_script(n_tenants, max_batch, events, *, max_queue: int = 128,
                serials: bool = False, pkg=None):
    """Replay one arrival script on manual ticks; returns (stub,
    scheduler, [(tenant, future)] admitted, [future] all).  ``serials``
    tags each request's ``deadline_s`` with its admission index;
    ``pkg`` is the reference's serve module, else the port's classes."""
    request = SpmmRequest if pkg is None else pkg.SpmmRequest
    stub = StubServer(max_batch, SpmmResponse if pkg is None
                      else pkg.SpmmResponse)
    sched = (SpmmScheduler if pkg is None else pkg.SpmmScheduler)(
        stub, max_queue_per_tenant=max_queue, clock=FakeClock())
    admitted, futures = [], []
    for serial, (tenant_i, d, ticks_after) in enumerate(events):
        req = _req(f"t{tenant_i}", d, request)
        if serials:
            req.deadline_s = float(serial)
        fut = sched.submit(req)
        futures.append(fut)
        if not fut.done():
            admitted.append((req.tenant, fut))
        for _ in range(ticks_after):
            sched.tick()
    while sched.tick():
        pass
    return stub, sched, admitted, futures


_scripts = st.tuples(
    st.integers(1, 4),                       # n_tenants
    st.integers(1, 4),                       # max_batch
    st.lists(st.tuples(st.integers(0, 3),            # tenant index
                       st.sampled_from((12, 20)),    # bucket 16 / 32
                       st.integers(0, 2)),           # ticks after
             min_size=1, max_size=30))


# -- scheduling properties (stub server) --------------------------------------

@settings(max_examples=60, deadline=None)
@given(_scripts)
def test_property_batches_bounded_and_single_bucket(script):
    n_tenants, max_batch, events = script
    events = [(t % n_tenants, d, k) for t, d, k in events]
    stub, _, admitted, _ = _run_script(n_tenants, max_batch, events)
    assert sum(len(b) for b in stub.batches) == len(admitted)
    for batch in stub.batches:
        assert 1 <= len(batch) <= max_batch
        assert len({d_bucket(r.x.shape[1]) for r in batch}) == 1


@settings(max_examples=60, deadline=None)
@given(_scripts)
def test_property_fifo_within_tenant(script):
    n_tenants, max_batch, events = script
    events = [(t % n_tenants, d, k) for t, d, k in events]
    stub, _, _, _ = _run_script(n_tenants, max_batch, events, serials=True)
    seen = {}
    for batch in stub.batches:
        for r in batch:
            seen.setdefault(r.tenant, []).append(r.deadline_s)
    for tenant, serials in seen.items():
        assert serials == sorted(serials), tenant
        assert len(serials) == len(set(serials))


@settings(max_examples=60, deadline=None)
@given(_scripts)
def test_property_no_starvation(script):
    n_tenants, max_batch, events = script
    events = [(t % n_tenants, d, k) for t, d, k in events]
    _, _, admitted, _ = _run_script(n_tenants, max_batch, events)
    K = len(admitted) + n_tenants
    for tenant, fut in admitted:
        assert fut.done(), tenant
        resp = fut.result(timeout=0)
        assert isinstance(resp, SpmmResponse)
        assert 0 <= resp.queue_wait_ticks <= K
        assert 0.0 < resp.tenant_share <= 1.0


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 6), st.integers(0, 8))
def test_property_overflow_is_explicit(limit, extra):
    stub = StubServer(max_batch=2)
    sched = SpmmScheduler(stub, max_queue_per_tenant=limit,
                          clock=FakeClock())
    futures = [sched.submit(_req("hot")) for _ in range(limit + extra)]
    for fut in futures[:limit]:
        assert not fut.done()
    for fut in futures[limit:]:
        assert fut.done() and fut.rejected
        r = fut.result(timeout=0)
        assert (r.reason, r.queue_depth, r.limit) == \
            ("queue_full", limit, limit)
    while sched.tick():
        pass
    for fut in futures[:limit]:
        assert isinstance(fut.result(timeout=0), SpmmResponse)
    assert sched.stats()["rejected"] == extra
    assert sched.stats()["dispatched"] == limit


@settings(max_examples=60, deadline=None)
@given(_scripts, st.integers(1, 4))
def test_property_same_batches_and_rejections_as_the_reference(script,
                                                               max_queue):
    """One arrival script through both packages' schedulers (stub
    servers): the same batches, member by member, every tick, the same
    rejections, the same waits and shares."""
    n_tenants, max_batch, events = script
    events = [(t % n_tenants, d, k) for t, d, k in events]
    runs = [_run_script(n_tenants, max_batch, events, max_queue=max_queue,
                        serials=True, pkg=pkg)
            for pkg in (ref_serve, None)]

    def batches(stub):
        return [[(r.tenant, r.deadline_s) for r in b] for b in stub.batches]

    def verdicts(futures):
        out = []
        for f in futures:
            v = f.result(timeout=0)
            out.append((type(v).__name__,
                        dataclasses.astuple(v) if hasattr(v, "reason")
                        else (v.tenant, v.queue_wait_ticks, v.tenant_share,
                              v.batch_size)))
        return out

    (ref_stub, ref_sched, _, ref_futs), (stub, sched, _, futs) = runs
    assert batches(stub) == batches(ref_stub)
    assert verdicts(futs) == verdicts(ref_futs)
    assert sched.stats() == ref_sched.stats()


# -- fairness, clock, executor, futures ---------------------------------------

def test_hot_tenant_cannot_starve_cold_tenant():
    stub = StubServer(max_batch=2)
    sched = SpmmScheduler(stub, max_queue_per_tenant=64, clock=FakeClock())
    for _ in range(32):
        sched.submit(_req("hot"))
    cold_waits = []
    for _ in range(16):
        fut = sched.submit(_req("cold"))
        sched.tick()
        sched.tick()
        resp = fut.result(timeout=0)
        assert isinstance(resp, SpmmResponse)
        cold_waits.append(resp.queue_wait_ticks)
    assert max(cold_waits) <= 2
    while sched.tick():
        pass
    assert sched.stats()["dispatched"] == 48


def test_fake_clock_stamps_queue_wait():
    clock = FakeClock()
    sched = SpmmScheduler(StubServer(max_batch=4), clock=clock)
    fut = sched.submit(_req("a"))
    clock.advance(1.5)
    sched.tick()
    resp = fut.result(timeout=0)
    assert resp.queue_wait_s == pytest.approx(1.5)
    assert resp.queue_wait_ticks == 0


def test_inline_executor_drives_scheduler():
    ex = InlineExecutor()
    sched = SpmmScheduler(StubServer(max_batch=4), executor=ex)
    assert ex.started
    futures = [sched.submit(_req("a")) for _ in range(3)]
    assert ex.kicks == 3
    assert ex.run_until_idle() == 3
    assert all(isinstance(f.result(timeout=0), SpmmResponse)
               for f in futures)
    sched.close()
    assert ex.stopped


def test_future_timeout_and_shutdown_rejection():
    sched = SpmmScheduler(StubServer(max_batch=4), clock=FakeClock())
    fut = sched.submit(_req("a"))
    with pytest.raises(TimeoutError):
        fut.result(timeout=0)
    sched.close(drain=False)
    r = fut.result(timeout=0)
    assert isinstance(r, SpmmRejected) and r.reason == "shutdown"
    assert sched.submit(_req("a")).result(timeout=0).reason == "shutdown"


def test_dispatch_error_resolves_futures():
    class FlakyServer(StubServer):
        def __init__(self):
            super().__init__(max_batch=4)
            self.boom = True

        def serve(self, requests):
            if self.boom:
                self.boom = False
                raise RuntimeError("transient dispatch failure")
            return super().serve(requests)

    sched = SpmmScheduler(FlakyServer(), clock=FakeClock())
    f1 = sched.submit(_req("a"))
    sched.tick()
    with pytest.raises(RuntimeError, match="transient"):
        f1.result(timeout=0)
    f2 = sched.submit(_req("a"))
    sched.tick()
    assert isinstance(f2.result(timeout=0), SpmmResponse)


def test_thread_tick_loop_takes_the_servers_device():
    sched = SpmmScheduler(SpmmServer(device="cpu", cache=JitCache()),
                          executor="thread")
    try:
        assert isinstance(sched.executor, ThreadTickLoop)
        assert sched.executor.device == "cpu"
    finally:
        sched.close()
    assert sched.executor is None


# -- real dispatch: the port's server on the CPU ------------------------------

MATS = ((48, 64, 0.08, "powerlaw", 11), (64, 48, 0.06, "uniform", 12),
        (40, 40, 0.12, "banded", 13))
DS = (20, 17, 24)                          # one shared bucket (32)


def _tenant_mats(pkg="port"):
    rng = np.random.default_rng(7)
    out = []
    for i, ((m, n, dens, fam, s), d) in enumerate(zip(MATS, DS)):
        a = (random_csr(m, n, density=dens, family=fam, seed=s,
                        device="cpu") if pkg == "port" else
             ref_csr.random_csr(m, n, density=dens, family=fam, seed=s))
        out.append((f"t{i}", a,
                    rng.standard_normal((n, d)).astype(np.float32)))
    return out


def poisson_trace(tenants, *, n_requests, mean_gap_s, seed=0,
                  deadlines=None, request=SpmmRequest):
    """``harness.poisson_trace``'s exponential-gap math (it builds the
    reference's requests): the same arrivals and picks per seed, as
    ``request`` objects."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(mean_gap_s, size=n_requests))
    picks = rng.integers(0, len(tenants), size=n_requests)
    events = []
    for i in range(n_requests):
        name, a, x = tenants[picks[i]]
        dl = deadlines[picks[i]] if deadlines is not None else None
        events.append(TraceEvent(at=float(arrivals[i]), request=request(
            tenant=name, a=a, x=x, deadline_s=dl)))
    return events


def _ref_ms(a, x):
    return spmm(a, torch.from_numpy(x), backend="ref", device="cpu",
                cache=JitCache()).numpy()


def test_scheduler_bit_identical_to_solo_dispatch():
    tenants = _tenant_mats()
    server = SpmmServer(device="cpu", max_batch=8, cache=JitCache())
    reqs = [SpmmRequest(tenant=n, a=a, x=x) for n, a, x in tenants]
    solo = [server.serve([r])[0] for r in reqs]
    clock = FakeClock()
    sched = SpmmScheduler(server, clock=clock)
    events = poisson_trace(tenants, n_requests=9, mean_gap_s=0.001, seed=3)
    futures = drive_trace(sched, clock, events, ticks_between=1)
    by_name = {n: s for (n, _, _), s in zip(tenants, solo)}
    assert len(futures) == 9
    for ev, fut in zip(sorted(events, key=lambda e: e.at), futures):
        resp = fut.result(timeout=0)
        assert isinstance(resp, SpmmResponse)
        assert np.array_equal(resp.y, by_name[ev.request.tenant].y)
    sched.close()


def test_one_trace_through_both_packages():
    """The reference's server and scheduler (interpret mode) and the
    port's (CPU) on one scripted trace: the same batch compositions per
    tick, the same rejections and outputs at 1e-5."""
    sides = {}
    for pkg in ("ref", "port"):
        mod = ref_serve if pkg == "ref" else None
        tenants = _tenant_mats(pkg)
        if mod is None:
            server = SpmmServer(device="cpu", max_batch=2, cache=JitCache())
            sched_cls, request = SpmmScheduler, SpmmRequest
        else:
            server = mod.SpmmServer(interpret=True, max_batch=2,
                                    cache=RefJitCache())
            sched_cls, request = mod.SpmmScheduler, mod.SpmmRequest
        served = []
        orig = server.serve

        def recording(reqs, orig=orig, served=served):
            served.append([r.tenant for r in reqs])
            return orig(reqs)

        server.serve = recording
        clock = FakeClock()
        sched = sched_cls(server, max_queue_per_tenant=2, clock=clock)
        events = poisson_trace(tenants, n_requests=12, mean_gap_s=0.002,
                               seed=5, request=request)
        # a burst (no ticks) for the first 8, then one tick an arrival
        futures = []
        for i, ev in enumerate(events):
            clock.advance_to(ev.at)
            futures.append(sched.submit(ev.request))
            if i >= 8:
                sched.tick()
        sched.close(drain=True)
        sides[pkg] = (served, [f.result(timeout=0) for f in futures])
    (ref_served, ref_out), (served, out) = sides["ref"], sides["port"]
    assert served == ref_served
    assert any(isinstance(r, SpmmRejected) for r in out)
    for got, want in zip(out, ref_out):
        assert type(got).__name__ == type(want).__name__
        if isinstance(got, SpmmRejected):
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            continue
        assert (got.tenant, got.batch_size, got.queue_wait_ticks,
                got.tenant_share) == (want.tenant, want.batch_size,
                                      want.queue_wait_ticks,
                                      want.tenant_share)
        np.testing.assert_allclose(got.y, want.y, rtol=1e-5, atol=1e-5)


def test_threaded_stress_one_miss_per_structure():
    mats = [random_csr(24, 24, density=0.15, seed=41, device="cpu"),
            random_csr(32, 24, density=0.12, seed=42, device="cpu")]
    xs = [np.ones((24, 12), np.float32), np.ones((24, 20), np.float32)]
    server = SpmmServer(device="cpu", max_batch=1, cache=JitCache())
    sched = SpmmScheduler(server, max_queue_per_tenant=64,
                          executor="thread")
    futures = []
    fut_lock = threading.Lock()

    def producer(k):
        for i in range(6):
            t = (k + i) % 2
            f = sched.submit(SpmmRequest(tenant=f"m{t}", a=mats[t], x=xs[t]))
            with fut_lock:
                futures.append(f)

    threads = [threading.Thread(target=producer, args=(k,))
               for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    sched.close(drain=True)
    assert len(futures) == 18
    for f in futures:
        assert isinstance(f.result(timeout=10), SpmmResponse)
    st_ = server.cache.stats()
    assert (st_["misses"], st_["entries"]) == (2, 2)
    assert sched.stats()["dispatched"] == 18


def test_cache_clear_mid_stream_still_satisfies_futures():
    tenants = _tenant_mats()
    server = SpmmServer(device="cpu", max_batch=2, cache=JitCache())
    sched = SpmmScheduler(server, clock=FakeClock())
    reqs = [SpmmRequest(tenant=n, a=a, x=x) for n, a, x in tenants]
    futures = [sched.submit(r) for r in reqs for _ in range(2)]
    sched.tick()
    server.cache.clear()
    while sched.tick():
        pass
    for f, r in zip(futures, [r for r in reqs for _ in range(2)]):
        resp = f.result(timeout=0)
        assert isinstance(resp, SpmmResponse)
        np.testing.assert_allclose(resp.y, _ref_ms(r.a, r.x), atol=1e-4)
    assert server.cache.stats()["misses"] > 0


def test_close_drain_serves_everything_queued():
    tenants = _tenant_mats()
    server = SpmmServer(device="cpu", max_batch=4, cache=JitCache())
    with SpmmScheduler(server, clock=FakeClock()) as sched:
        futures = [sched.submit(SpmmRequest(tenant=n, a=a, x=x))
                   for n, a, x in tenants]
    assert sched.pending == 0
    for f in futures:
        assert isinstance(f.result(timeout=0), SpmmResponse)


# -- batched-autotune knob resolution (DESIGN.md §14.3) -----------------------

def test_batched_dispatch_uses_resolved_tuned_knobs():
    tenants = _tenant_mats()
    cache = JitCache()
    server = SpmmServer(device="cpu", max_batch=8, autotune=True,
                        measure=lambda compiled, vals, x: 0.0, cache=cache)
    reqs = [SpmmRequest(tenant=n, a=a, x=x) for n, a, x in tenants]
    for resp, r in zip(server.serve(reqs), reqs):
        np.testing.assert_allclose(resp.y, _ref_ms(r.a, r.x), atol=1e-4)
    results = [lookup_tune_result(
        r.a, 32, backend=server.backend, device="cpu",
        candidates=server._tune_candidates, cache=cache) for r in reqs]
    assert all(res is not None for res in results)
    cfg = resolve_batch_config(results, server._fallback_config)
    batch_keys = [k for k in cache._entries if k[0] == "spmm_batch"]
    assert len(batch_keys) == 1
    artifact = cache.peek(batch_keys[0])
    assert artifact.strategy == cfg.strategy
    assert (artifact.bm, artifact.bk) == (cfg.bm, cfg.bk)
    thresholds = tuple(res.config.merge_threshold for res in results)
    expected = thresholds[0] if len(set(thresholds)) == 1 else thresholds
    assert artifact.merge_threshold == expected


def test_resolve_batch_config_majority_and_min():
    fb = TuneConfig(strategy="nnz_split", bm=8, bk=8, mxu_gain=4.0,
                    merge_threshold=0, staging="resident")

    def _res(strategy, mt):
        cfg = dataclasses.replace(fb, strategy=strategy, merge_threshold=mt)
        return type("R", (), {"config": cfg})()

    out = resolve_batch_config(
        [_res("row_split", 32), _res("row_split", 8), None], fb)
    assert out.strategy == "row_split" and out.merge_threshold == 0
    assert resolve_batch_config([], fb) is fb
    tie = resolve_batch_config([_res("row_split", 8), _res("nnz_split", 8)],
                               fb)
    assert tie.strategy == "nnz_split"


# -- SLA-aware eviction (DESIGN.md §14.4) -------------------------------------

def test_sla_priority_protects_entry_from_lru_eviction():
    cache = JitCache(capacity=2)
    cache.get_or_build(("sla",), lambda: "protected", priority=1.0)
    cache.get_or_build(("a",), lambda: 1)
    cache.get_or_build(("b",), lambda: 2)
    assert cache.peek(("sla",)) == "protected"
    assert cache.peek(("a",)) is None
    assert cache.stats()["evictions"] == 1
    cache.get_or_build(("c",), lambda: 3, priority=1.0)
    assert cache.peek(("b",)) is None


def test_deadline_hint_sets_artifact_priority():
    cache = JitCache()
    server = SpmmServer(device="cpu", cache=cache)
    a = random_csr(24, 24, density=0.2, seed=55, device="cpu")
    x = np.ones((24, 12), np.float32)
    server.serve([SpmmRequest(tenant="sla", a=a, x=x, deadline_s=0.01)])

    def priorities():
        return [e.priority for k, e in cache._entries.items()
                if k[0] == "spmm" and k[1] == a.fingerprint]

    assert max(priorities()) == pytest.approx(100.0)
    server.serve([SpmmRequest(tenant="sla", a=a, x=x)])
    assert max(priorities()) == pytest.approx(100.0)


# -- invalid-plan admission control (DESIGN.md §15) ---------------------------

def _invalid_csr(m=16, n=16, nnz=8, seed=7):
    """Column ids that overrun n: CSRMatrix checks row_ptr, not column
    bounds, so the plan verifier must catch it at admission."""
    rng = np.random.default_rng(seed)
    row_ptr = np.zeros(m + 1, np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(rng.integers(0, m, nnz),
                                        minlength=m))
    cols = rng.integers(0, n, nnz).astype(np.int32)
    cols[0] = n + 4
    return CSRMatrix((m, n), row_ptr, cols, torch.ones(nnz))


def test_invalid_plan_rejected_batchmates_survive():
    server = SpmmServer(device="cpu", max_batch=8, cache=JitCache())
    assert server.validate == "full"
    sched = SpmmScheduler(server, clock=FakeClock())
    good = random_csr(16, 16, density=0.2, seed=8, device="cpu")
    x = np.ones((16, 12), np.float32)
    f_good1 = sched.submit(SpmmRequest(tenant="ok", a=good, x=x))
    f_bad = sched.submit(SpmmRequest(tenant="ok", a=_invalid_csr(), x=x))
    f_good2 = sched.submit(SpmmRequest(tenant="ok", a=good, x=x))
    while sched.tick():
        pass
    rej = f_bad.result(timeout=0)
    assert isinstance(rej, SpmmRejected) and rej.reason == "invalid_plan"
    for f in (f_good1, f_good2):
        resp = f.result(timeout=0)
        assert isinstance(resp, SpmmResponse)
        np.testing.assert_allclose(resp.y, _ref_ms(good, x), atol=1e-4)
    assert sched.stats()["rejected"] >= 1
    sched.close()


def test_all_invalid_batch_still_progresses_and_closes():
    server = SpmmServer(device="cpu", max_batch=4, cache=JitCache())
    with SpmmScheduler(server, clock=FakeClock()) as sched:
        futures = [sched.submit(SpmmRequest(
            tenant="bad", a=_invalid_csr(seed=20 + i),
            x=np.ones((16, 12), np.float32))) for i in range(3)]
    assert sched.pending == 0
    for f in futures:
        rej = f.result(timeout=0)
        assert isinstance(rej, SpmmRejected) and rej.reason == "invalid_plan"


def test_direct_serve_raises_on_invalid_plan():
    server = SpmmServer(device="cpu", cache=JitCache())
    with pytest.raises(PlanVerificationError):
        server.serve([SpmmRequest(tenant="bad", a=_invalid_csr(),
                                  x=np.ones((16, 12), np.float32))])
