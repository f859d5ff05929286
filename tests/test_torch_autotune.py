"""The port's autotuner (``core/autotune.py``) and its cost model
(``analysis/roofline.py``, ``analysis/memmodel.py``) against the
reference's, on the CPU.

The candidate grid, the memory model and the prediction are held to the
reference exactly (the reference's roofline constants are the TPU's, so
the prediction is compared with the reference's module patched to the
port's H100 constants — the reference's file is never edited).  The
search runs on injected fake timers, as ``tests/test_autotune.py`` runs
the reference's, and its winner and output are held to the reference's.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import autotune as ref_autotune
from repro.core import csr as ref_csr
from repro.core import plan as ref_plan
from repro.core.jit_cache import JitCache as RefJitCache
from repro.analysis import memmodel as ref_memmodel
from repro_torch import convert
from repro_torch.analysis import memmodel, roofline
from repro_torch.core import autotune, plan
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels import ops

ref_spmm_mod = importlib.import_module("repro.core.spmm")
spmm_mod = importlib.import_module("repro_torch.core.spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED = ("pallas_ell", "pallas_bcsr")


def _const_timer(compiled, vals, x):
    return 1.0


@pytest.fixture
def pair():
    """The reference's powerlaw fixture of tests/test_autotune.py, and
    the same instance in the port."""
    a = ref_csr.random_csr(48, 40, density=0.08, family="powerlaw", seed=7)
    b = convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                               np.asarray(a.vals), device="cpu")
    return a, b


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's autotune module with the port's rates."""
    monkeypatch.setattr(ref_autotune, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(ref_autotune, "HBM_BW", roofline.HBM_BW)


def test_card_constants_and_trip_weight():
    # H100 SXM5 data sheet: fp32 without tensor cores, HBM3; the trip
    # weight is the reference's tie-break, not a measurement of the card
    assert roofline.PEAK_FLOPS == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert autotune.TRIP_OVERHEAD_S == ref_autotune.TRIP_OVERHEAD_S
    assert autotune.STRATEGIES == ref_autotune.STRATEGIES


@pytest.mark.parametrize("kw", (
    {}, dict(bm=4, bk=1, mxu_gain=2.0, staging="dma"),
    dict(bm=16, merge_thresholds=(0, 64))))
def test_default_candidates_equal_the_reference(kw):
    got = autotune.default_candidates(**kw)
    want = ref_autotune.default_candidates(**kw)
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]
    assert [c.compile_kwargs() for c in got] == \
        [c.compile_kwargs() for c in want]
    assert len(set(got)) == len(got)      # frozen, hashable


@pytest.mark.parametrize("strategy", autotune.STRATEGIES)
@pytest.mark.parametrize("mixed", (False, True))
@pytest.mark.parametrize("merge_threshold", (0, 32))
def test_spmm_hbm_traffic_is_the_reference_dict(pair, strategy, mixed,
                                                merge_threshold):
    a, _ = pair
    dicts = []
    for plan_mod, mm in ((ref_plan, ref_memmodel), (plan, memmodel)):
        ws = plan_mod.build_workspace(
            a.row_ptr, a.col_indices, a.shape, 20, strategy=strategy,
            mixed=mixed, merge_threshold=merge_threshold)
        dicts.append(mm.spmm_hbm_traffic(
            slots=int(ws.gather_flat.shape[0]),
            cols_entries=int(ws.cols_flat.shape[0]),
            padded_nnz=int(ws.gather_flat.shape[0]),
            ws_rows=ws.ws_rows, d_pad=128))
    assert dicts[0] == dicts[1]


@pytest.mark.parametrize("mixed", (False, True))
@pytest.mark.parametrize("d", (4, 130))
def test_predict_seconds_is_the_reference_formula(pair, h100_reference,
                                                  mixed, d):
    a, b = pair
    for cfg in autotune.default_candidates(staging="dma"):
        ref_cfg = ref_autotune.TuneConfig(*dataclasses.astuple(cfg))
        got = autotune.predict_seconds(b, d, cfg, mixed=mixed)
        want = ref_autotune.predict_seconds(a, d, ref_cfg, mixed=mixed)
        assert got == pytest.approx(want, rel=1e-12), cfg


def test_predict_seconds_rewards_merging(pair):
    _, b = pair
    p0 = autotune.predict_seconds(b, 4, autotune.TuneConfig())
    p1 = autotune.predict_seconds(b, 4,
                                  autotune.TuneConfig(merge_threshold=32))
    assert 0 < p1 < p0


@pytest.mark.parametrize("backend", FUSED)
def test_constant_timer_picks_the_reference_winner(pair, h100_reference,
                                                   backend):
    a, b = pair
    compiled, res = autotune.autotune_spmm_with_result(
        b, 4, backend=backend, device="cpu", measure=_const_timer,
        cache=JitCache())
    _, want = ref_autotune.autotune_spmm_with_result(
        a, 4, backend=backend, interpret=True, measure=_const_timer,
        cache=RefJitCache())
    best_pred = min(res.measured_s, key=lambda c: res.predicted_s[c])
    assert res.config == best_pred
    assert dataclasses.astuple(res.config) == \
        dataclasses.astuple(want.config)
    assert len(res.predicted_s) == len(autotune.default_candidates())
    assert sorted(dataclasses.astuple(c) for c in res.measured_s) == \
        sorted(dataclasses.astuple(c) for c in want.measured_s)
    assert res.best_measured_s == 1.0
    # the artifact is the winner's compile and runs
    assert compiled.strategy == res.config.strategy
    assert compiled.merge_threshold == res.config.merge_threshold
    y = compiled(b.vals, torch.zeros(b.n, 4))
    assert y.shape == (b.m, 4)


def test_rigged_timer_overrides_the_prediction(pair):
    _, b = pair
    _, probe = autotune.autotune_spmm_with_result(
        b, 4, backend="pallas_ell", device="cpu", measure=_const_timer,
        cache=JitCache())
    finalists = sorted(probe.measured_s, key=lambda c: probe.predicted_s[c])
    calls = []

    def rigged(compiled, vals, x):
        # finalists are measured in predicted order: the last is fastest
        calls.append(1)
        return 0.5 if len(calls) == len(finalists) else 2.0

    _, res = autotune.autotune_spmm_with_result(
        b, 4, backend="pallas_ell", device="cpu", measure=rigged,
        cache=JitCache())
    assert res.config == finalists[-1]
    assert res.best_measured_s == 0.5


def test_second_autotune_compile_is_a_pure_hit(pair):
    _, b = pair
    cache = JitCache()
    ops.reset_dispatch_counts()
    c1 = spmm_mod.compile_spmm(b, 4, backend="pallas_ell", device="cpu",
                               autotune=True, measure=_const_timer,
                               cache=cache)
    assert ops.BUILD_SECONDS["tune"] > 0
    assert ops.BUILD_SECONDS["plan"] > 0
    s1 = cache.stats()
    ops.reset_dispatch_counts()
    c2 = spmm_mod.compile_spmm(b, 4, backend="pallas_ell", device="cpu",
                               autotune=True, measure=_const_timer,
                               cache=cache)
    s2 = cache.stats()
    assert c2 is c1
    assert s2["misses"] == s1["misses"] and s2["hits"] > s1["hits"]
    assert ops.BUILD_SECONDS["tune"] == 0.0
    assert ops.BUILD_SECONDS["plan"] == 0.0
    # the memoized result is peekable with the key the search used
    res = autotune.lookup_tune_result(
        b, 4, backend="pallas_ell", device="cpu",
        candidates=autotune.default_candidates(), cache=cache)
    assert res is not None and res.config.strategy == c1.strategy


@pytest.mark.parametrize("backend", FUSED)
def test_autotuned_output_matches_the_reference(pair, h100_reference,
                                                backend):
    a, b = pair
    x = np.random.default_rng(0).standard_normal((a.n, 12)).astype(
        np.float32)
    want = ref_spmm_mod.spmm(a, x, backend=backend, interpret=True,
                             autotune=True, measure=_const_timer,
                             cache=RefJitCache())
    got = spmm_mod.spmm(b, torch.from_numpy(x), backend=backend,
                        device="cpu", autotune=True, measure=_const_timer,
                        cache=JitCache())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_default_measure_hook_times_real_forwards(pair):
    _, b = pair
    c = spmm_mod.compile_spmm(b, 4, backend="pallas_ell", device="cpu",
                              cache=JitCache())
    ops.reset_dispatch_counts()
    s = autotune.device_time_measure(c, b.vals, torch.ones(b.n, 4),
                                     repeats=2)
    assert s > 0
    assert ops.DISPATCH_COUNTS["ell_fused"] == 3      # warm-up + 2


_votes = st.lists(st.one_of(st.none(), st.builds(
    autotune.TuneConfig,
    strategy=st.sampled_from(autotune.STRATEGIES),
    bm=st.sampled_from((4, 8)), bk=st.sampled_from((1, 8)),
    mxu_gain=st.sampled_from((2.0, 4.0)),
    merge_threshold=st.sampled_from((0, 8, 32)),
    staging=st.sampled_from(("resident", "dma")))), max_size=6)


@settings(max_examples=80, deadline=None)
@given(_votes, st.sampled_from(autotune.STRATEGIES))
def test_resolve_batch_config_agrees_with_the_reference(votes, fb_strategy):
    fallback = autotune.TuneConfig(strategy=fb_strategy)

    def results(cls):
        return [None if v is None else cls(
            config=(ref_autotune.TuneConfig(*dataclasses.astuple(v))
                    if cls is ref_autotune.TuneResult else v),
            predicted_s={}, measured_s={}) for v in votes]

    got = autotune.resolve_batch_config(results(autotune.TuneResult),
                                        fallback)
    want = ref_autotune.resolve_batch_config(
        results(ref_autotune.TuneResult),
        ref_autotune.TuneConfig(*dataclasses.astuple(fallback)))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_autotune_rejects_what_has_nothing_to_tune(pair):
    _, b = pair
    with pytest.raises(ValueError, match="nothing to tune"):
        autotune.autotune_spmm(b, 4, backend="ref", device="cpu",
                               cache=JitCache())
    with pytest.raises(ValueError, match="at least one candidate"):
        autotune.autotune_spmm(b, 4, backend="pallas_ell", device="cpu",
                               candidates=[], cache=JitCache())


def test_tune_key_carries_the_resolved_device(pair):
    _, b = pair
    key = autotune.spmm_tune_key(
        b, 4, backend="pallas_ell", device="cpu", x_sharding="replicated",
        mesh=None, candidates=autotune.default_candidates(), top_k=0)
    assert key[0] == "spmm_tune" and key[4] == "cpu" and key[-1] == 1


def test_bounded_cache_autotune_evicts_and_stays_correct(pair):
    _, b = pair
    cache = JitCache(capacity=2)
    c1 = autotune.autotune_spmm(b, 4, backend="pallas_ell", device="cpu",
                                measure=_const_timer, cache=cache)
    assert cache.stats()["evictions"] > 0
    c2 = autotune.autotune_spmm(b, 4, backend="pallas_ell", device="cpu",
                                measure=_const_timer, cache=cache)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b.n, 4)).astype(np.float32))
    assert torch.equal(c1(b.vals, x), c2(b.vals, x))


def test_cache_priority_reaches_the_entry(pair):
    _, b = pair
    cache = JitCache()
    spmm_mod.compile_spmm(b, 4, backend="pallas_ell", device="cpu",
                          cache_priority=3.0, cache=cache)
    (entry,) = cache._entries.values()
    assert entry.priority == 3.0
