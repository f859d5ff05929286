"""The port's serving tier (``core.spmm.compile_batched_spmm``,
``launch/serve.py``) against the reference's, on the CPU.

Batched == solo bit for bit on both fused backends and both stagings;
the batched artifact's tables, its output and the served responses held
to the reference's (interpret mode) — tables exactly, outputs at
rtol = atol = 1e-5; one fused dispatch per batch; the cache behaviour
across rounds and threads; and the ``--smoke`` CLI on ``--device cpu``.
"""
import importlib
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import csr as ref_csr
from repro.core.jit_cache import JitCache as RefJitCache
from repro.launch import serve as ref_serve
from repro_torch.core import random_csr
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels import ops
from repro_torch.launch import serve

ref_spmm_mod = importlib.import_module("repro.core.spmm")
spmm_mod = importlib.import_module("repro_torch.core.spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED = ("pallas_ell", "pallas_bcsr")
STAGINGS = ("resident", "dma")
# the reference's test tenants: mixed shapes and families, d within one
# bucket (32)
MATS = ((48, 64, 0.08, "powerlaw", 11), (64, 48, 0.06, "uniform", 12),
        (40, 40, 0.12, "banded", 13))
DS = (20, 17, 24)


def _tenants(pkg="port", seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i, ((m, n, dens, fam, s), d) in enumerate(zip(MATS, DS)):
        if pkg == "port":
            a = random_csr(m, n, density=dens, family=fam, seed=s,
                           device="cpu")
            req = serve.SpmmRequest
        else:
            a = ref_csr.random_csr(m, n, density=dens, family=fam, seed=s)
            req = ref_serve.SpmmRequest
        out.append(req(tenant=f"t{i}", a=a, x=rng.standard_normal(
            (n, d)).astype(np.float32)))
    return out


# -- d bucketing --------------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(st.integers(-4, 5000))
def test_d_bucket_matches_the_reference(d):
    if d < 1:
        with pytest.raises(ValueError):
            serve.d_bucket(d)
        with pytest.raises(ValueError):
            ref_serve.d_bucket(d)
        return
    assert serve.d_bucket(d) == ref_serve.d_bucket(d)


@pytest.mark.parametrize("deadline", (None, 0.0, 1e-6, 0.01, 2.5))
def test_sla_priority_matches_the_reference(deadline):
    assert serve._sla_priority(deadline) == ref_serve._sla_priority(deadline)


# -- the batched artifact -----------------------------------------------------

@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("staging", STAGINGS)
def test_batched_bit_identical_to_solo(backend, staging):
    reqs = _tenants()
    server = serve.SpmmServer(backend=backend, staging=staging,
                              device="cpu", max_batch=8, cache=JitCache())
    solo = [server.serve([r])[0] for r in reqs]
    batched = server.serve(reqs)
    assert all(r.batch_size == len(reqs) for r in batched)
    for s, b in zip(solo, batched):
        assert s.y.shape == b.y.shape
        assert np.array_equal(s.y, b.y), f"{b.tenant}: batched != solo"
    # and the artifacts directly, as tensors
    compiled = spmm_mod.compile_batched_spmm(
        [r.a for r in reqs], 32, backend=backend, staging=staging,
        device="cpu", merge_threshold=16, cache=JitCache())
    ys = compiled([r.a.vals for r in reqs], [r.x for r in reqs])
    for r, y in zip(reqs, ys):
        c = spmm_mod.compile_spmm(r.a, 32, backend=backend, staging=staging,
                                  device="cpu", merge_threshold=16,
                                  cache=JitCache())
        x = np.zeros((r.a.n, 32), np.float32)
        x[:, :r.x.shape[1]] = r.x
        assert torch.equal(y, c(r.a.vals, torch.from_numpy(x)))


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("staging", STAGINGS)
def test_batched_matches_the_reference(backend, staging):
    ref_reqs, reqs = _tenants("ref"), _tenants()
    want = ref_spmm_mod.compile_batched_spmm(
        [r.a for r in ref_reqs], 32, backend=backend, staging=staging,
        interpret=True, merge_threshold=(0, 16, 32), cache=RefJitCache())(
            [np.asarray(r.a.vals) for r in ref_reqs],
            [r.x for r in ref_reqs])
    got = spmm_mod.compile_batched_spmm(
        [r.a for r in reqs], 32, backend=backend, staging=staging,
        device="cpu", merge_threshold=(0, 16, 32), cache=JitCache())(
            [r.a.vals for r in reqs], [r.x for r in reqs])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("merge_threshold", (0, 16, (0, 8, 64)))
def test_batched_tables_equal_the_reference(backend, merge_threshold):
    ref_reqs, reqs = _tenants("ref"), _tenants()
    want = ref_spmm_mod.CompiledBatchedSpmm(
        [r.a for r in ref_reqs], 32, backend=backend, interpret=True,
        merge_threshold=merge_threshold).batched_workspace
    got = spmm_mod.CompiledBatchedSpmm(
        [r.a for r in reqs], 32, backend=backend, device="cpu",
        merge_threshold=merge_threshold).batched_workspace
    for field in ("blk_off", "blk_L", "blk_tag", "blk_coff", "cols_flat",
                  "gather_flat", "inv_perm", "row_splits", "val_splits"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            field
    for field in ("n_requests", "num_blocks", "ws_rows", "x_rows_pad",
                  "max_span", "max_cspan", "merge_width"):
        assert getattr(got, field) == getattr(want, field), field


def test_stacked_operand_equals_the_reference():
    ref_reqs, reqs = _tenants("ref"), _tenants()
    want = ref_spmm_mod.CompiledBatchedSpmm(
        [r.a for r in ref_reqs], 32, backend="pallas_bcsr", bk=16,
        interpret=True).stack_inputs([r.x for r in ref_reqs])
    got = spmm_mod.CompiledBatchedSpmm(
        [r.a for r in reqs], 32, backend="pallas_bcsr", bk=16,
        device="cpu").stack_inputs([r.x for r in reqs])
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("backend", FUSED)
def test_batched_is_one_fused_dispatch(backend):
    reqs = _tenants()
    compiled = spmm_mod.compile_batched_spmm(
        [r.a for r in reqs], 32, backend=backend, device="cpu",
        staging="dma", cache=JitCache())
    counter = "ell_fused" if backend == "pallas_ell" else "bcsr_fused"
    ops.reset_dispatch_counts()
    ys = compiled([r.a.vals for r in reqs], [r.x for r in reqs])
    assert ops.DISPATCH_COUNTS[counter] == 1
    assert ops.DISPATCH_COUNTS[counter + "_dma"] == 1
    assert ops.DISPATCH_COUNTS[counter + "_sharded"] == 0
    assert len(ys) == len(reqs)
    compiled([r.a.vals for r in reqs], [r.x for r in reqs])
    assert ops.DISPATCH_COUNTS[counter] == 2


def test_batched_workspace_uniform_windows():
    reqs = _tenants()
    bw = spmm_mod.CompiledBatchedSpmm(
        [r.a for r in reqs], 32, backend="pallas_ell",
        device="cpu").batched_workspace
    R = bw.n_requests
    B = bw.num_blocks // R
    S = bw.gather_flat.size // R
    Sc = bw.cols_flat.size // R
    for q in range(bw.num_blocks):
        r = q // B
        assert r * S <= bw.blk_off[q]
        assert bw.blk_off[q] + bw.max_span <= (r + 1) * S
        assert r * Sc <= bw.blk_coff[q]
        assert bw.blk_coff[q] + bw.max_cspan <= (r + 1) * Sc
    assert 0 <= bw.gather_flat.min()
    assert bw.gather_flat.max() <= sum(r.a.nnz for r in reqs)


def test_batched_cache_key_and_threshold_normalisation():
    reqs = _tenants()
    cache = JitCache()
    mats = [r.a for r in reqs]
    c1 = spmm_mod.compile_batched_spmm(mats, 32, device="cpu",
                                       merge_threshold=(8, 8, 8),
                                       cache_priority=2.0, cache=cache)
    c2 = spmm_mod.compile_batched_spmm(mats, 32, device="cpu",
                                       merge_threshold=8, cache=cache)
    assert c1 is c2 and c1.merge_threshold == 8
    assert c1.backend == "pallas_ell"        # "auto" stays fused on the CPU
    (key,) = cache._entries
    assert key[0] == "spmm_batch" and "cpu" in key
    assert key[1] == tuple(a.fingerprint for a in mats)
    assert cache._entries[key].priority == 2.0
    for t in ((0, 8, 32), 5):
        assert spmm_mod._normalize_batch_merge_threshold(t, 3) == \
            ref_spmm_mod._normalize_batch_merge_threshold(t, 3)
    with pytest.raises(ValueError, match="3 entries"):
        spmm_mod.compile_batched_spmm(mats, 32, device="cpu",
                                      merge_threshold=(0, 8), cache=cache)
    with pytest.raises(ValueError, match="fused"):
        spmm_mod.CompiledBatchedSpmm(mats, 32, backend="ref", device="cpu")


def test_batched_forward_checks_its_operands():
    reqs = _tenants()
    c = spmm_mod.CompiledBatchedSpmm([r.a for r in reqs], 32, device="cpu")
    x = torch.from_numpy(c.stack_inputs([r.x for r in reqs]))
    vals = torch.cat([r.a.vals for r in reqs])
    with pytest.raises(ValueError, match="stacked"):
        c.forward(vals, x[1:])
    with pytest.raises(ValueError, match="values"):
        c.forward(vals[1:], x)


# -- the endpoint -------------------------------------------------------------

@pytest.mark.parametrize("backend", FUSED)
def test_served_responses_match_the_reference_server(backend):
    ref_reqs, reqs = _tenants("ref"), _tenants()
    want = ref_serve.SpmmServer(backend=backend, interpret=True,
                                max_batch=2, cache=RefJitCache()).serve(
                                    ref_reqs)
    got = serve.SpmmServer(backend=backend, device="cpu", max_batch=2,
                           cache=JitCache()).serve(reqs)
    for g, w in zip(got, want):
        assert (g.tenant, g.batch_size, g.cache_hit) == \
            (w.tenant, w.batch_size, w.cache_hit)
        assert isinstance(g.y, np.ndarray) and g.y.shape == w.y.shape
        np.testing.assert_allclose(g.y, w.y, **TOL)


def test_served_responses_match_ref_numerics():
    reqs = _tenants()
    server = serve.SpmmServer(device="cpu", cache=JitCache())
    for resp, req in zip(server.serve(reqs), reqs):
        ref = spmm_mod.spmm(req.a, torch.from_numpy(req.x), backend="ref",
                            device="cpu", cache=JitCache())
        np.testing.assert_allclose(resp.y, ref.numpy(), atol=1e-4)


def test_mixed_buckets_split_into_separate_dispatches():
    rng = np.random.default_rng(3)
    a = random_csr(32, 32, density=0.1, seed=5, device="cpu")
    r16 = serve.SpmmRequest("small", a, rng.standard_normal(
        (32, 12)).astype(np.float32))
    r64 = serve.SpmmRequest("wide", a, rng.standard_normal(
        (32, 40)).astype(np.float32))
    server = serve.SpmmServer(device="cpu", cache=JitCache())
    out = server.serve([r16, r64, r16, r64])
    assert [o.tenant for o in out] == ["small", "wide", "small", "wide"]
    assert server.batches_dispatched == 2
    assert all(o.batch_size == 2 for o in out)
    assert out[0].y.shape == (32, 12) and out[1].y.shape == (32, 40)
    np.testing.assert_array_equal(out[0].y, out[2].y)


def test_second_round_is_pure_cache_hits():
    reqs = _tenants()
    server = serve.SpmmServer(device="cpu", cache=JitCache())
    first = server.serve(reqs)
    assert not any(r.cache_hit for r in first)
    hits0 = server.cache.stats()["hits"]
    ops.reset_dispatch_counts()            # clears BUILD_SECONDS too
    second = server.serve(reqs)
    assert all(r.cache_hit for r in second)
    assert ops.BUILD_SECONDS["plan"] == 0.0
    assert ops.BUILD_SECONDS["pack"] == 0.0
    assert ops.DISPATCH_COUNTS["ell_fused"] == 1
    st_ = server.cache.stats()
    assert st_["hits"] > hits0 and st_["misses"] == st_["entries"]
    for a, b in zip(first, second):
        assert np.array_equal(a.y, b.y)


def test_concurrent_first_requests_single_flight():
    a = random_csr(48, 48, density=0.08, seed=9, device="cpu")
    server = serve.SpmmServer(device="cpu", cache=JitCache())
    barrier = threading.Barrier(6)
    errs = []

    def hit():
        try:
            barrier.wait(timeout=30)
            server.warmup(a, 24)
        except BaseException as e:          # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hit) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    st_ = server.cache.stats()
    assert (st_["misses"], st_["entries"], st_["hits"]) == (1, 1, 5)


def test_clear_while_a_build_is_in_flight():
    """A build that started before ``clear()`` hands its artifact to its
    own caller but never re-enters the cache."""
    a = random_csr(24, 24, density=0.2, seed=31, device="cpu")
    cache = JitCache()
    started, release = threading.Event(), threading.Event()
    orig = spmm_mod.CompiledSpmm
    got = []

    def slow(*args, **kw):
        started.set()
        assert release.wait(30)
        return orig(*args, **kw)

    server = serve.SpmmServer(device="cpu", cache=cache)
    spmm_mod.CompiledSpmm = slow
    try:
        t = threading.Thread(target=lambda: got.append(server.warmup(a, 12)))
        t.start()
        assert started.wait(30)
        cache.clear()
        release.set()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        spmm_mod.CompiledSpmm = orig
    assert len(got) == 1 and isinstance(got[0], orig)
    assert cache.stats()["entries"] == 0 and cache._inflight == {}
    assert server.warmup(a, 12) is not got[0]


def test_server_stats_keys_equal_the_reference():
    reqs, ref_reqs = _tenants(), _tenants("ref")
    server = serve.SpmmServer(device="cpu", cache=JitCache())
    server.serve(reqs[:2])
    ref_server = ref_serve.SpmmServer(interpret=True, cache=RefJitCache())
    ref_server.serve(ref_reqs[:2])
    s, w = server.stats(), ref_server.stats()
    assert set(s) == set(w)
    for k in ("tenants", "requests_served", "batches_dispatched", "entries",
              "hits", "misses", "evictions"):
        assert s[k] == w[k], k


def test_server_resolves_its_knobs():
    server = serve.SpmmServer(device="cpu", cache=JitCache())
    assert (server.device, server.backend, server.staging,
            server.validate) == ("cpu", "pallas_ell", "resident", "full")
    with pytest.raises(ValueError, match="fused"):
        serve.SpmmServer(backend="ref", device="cpu", cache=JitCache())
    with pytest.raises(ValueError, match="max_batch"):
        serve.SpmmServer(device="cpu", max_batch=0, cache=JitCache())


def test_a_server_for_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.SpmmServer(cache=JitCache())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmm_mod.compile_batched_spmm([], 8, cache=JitCache())


def test_the_lm_driver_is_not_ported_yet(capsys):
    # generate() runs the recurrent architectures now too
    # (tests/test_torch_generate.py holds them to the reference), on the
    # CLI and on a config of the rwkv slot alone
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "1", "--prompt-len", "4", "--gen",
                           "2"]) == 0
        assert f"{arch}-smoke on cpu: generated (1, 6)" in \
            capsys.readouterr().out
    from repro_torch.configs import ArchConfig
    from repro_torch.models import Model
    rwkv = ArchConfig(name="rwkv-like", family="ssm", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=0, head_dim=16,
                      d_ff=128, vocab_size=256, pattern=("rwkv",),
                      dtype="float32")
    model = Model(rwkv)
    out = serve.generate(model, model.init(device="cpu"),
                         torch.zeros((1, 4), dtype=torch.long), gen_len=2,
                         cache_len=6, device="cpu")
    assert out.shape == (1, 6) and int(out.max()) < rwkv.vocab_size


def test_the_lm_driver_generates_on_the_cpu(capsys):
    assert serve.main(["--arch", "qwen2.5-32b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4", "--gen",
                       "3"]) == 0
    assert "qwen2.5-32b-smoke on cpu: generated (2, 7)" in \
        capsys.readouterr().out


def test_smoke_cli_on_the_cpu(capsys):
    assert serve.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] smoke OK" in out
    assert "12 requests in 9 fused dispatches" in out
