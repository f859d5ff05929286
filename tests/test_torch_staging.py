"""The port's staged lowering (``staging="dma"``: K3/K4) against the
reference's, on the CPU.

The staged kernels' plain versions copy each trip's windows the way the
CUDA kernels do (aligned-down starts, chunks for a window over the
ring's slot) into buffers whose unfilled entries are NaN or out of
range, so a window error shows here.  They are held to the reference's
``staging="dma"`` in interpret mode at rtol = atol = 1e-5 (the MXU
step's dot product may sum in another order) and to the port's own
resident path bit for bit, as the reference holds its two lowerings.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import csr as ref_csr
from repro.core.jit_cache import JitCache as RefJitCache
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels import (ops, spmm_bcsr_fused_plain,
                                 spmm_bcsr_fused_staged,
                                 spmm_bcsr_fused_staged_plain,
                                 spmm_ell_fused_plain, spmm_ell_fused_staged,
                                 spmm_ell_fused_staged_plain)
from test_torch_kernels import BCSR, ELL, call, torch_args, workspace

# the packages' __init__ re-export functions over the modules of the
# same name
ref_spmm_mod = importlib.import_module("repro.core.spmm")
spmm_mod = importlib.import_module("repro_torch.core.spmm")
k3_mod = importlib.import_module("repro_torch.kernels.spmm_ell_fused")

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED = ("pallas_ell", "pallas_bcsr")


def mixed_csr(seed=0, m=48, n=64):
    """tests/test_staging.py's ``_mixed_csr``: dense block-rows (MXU
    bait) and a ragged sparse tail (VPU bait)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(16):
        j0 = (i // 8) * 16
        dense[i, j0:j0 + 16] = rng.standard_normal(16)
    for i in range(16, m):
        k = rng.integers(1, 4)
        dense[i, rng.choice(n, size=k, replace=False)] = (
            rng.standard_normal(k))
    return ref_csr.CSRMatrix.from_dense(dense)


FIXTURES = {
    "mixed": lambda: mixed_csr(seed=2),
    "powerlaw": lambda: ref_csr.random_csr(120, 96, density=0.06,
                                           family="powerlaw", seed=4),
}


def hub_csr(seed=0, m=40, n=600):
    """One hub row over every column plus a sparse tail: the hub's trip
    window (8 * 600 slots, or 75 MXU block steps) is far over a slot."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    dense[3] = rng.standard_normal(n)
    for i in range(m):
        dense[i, rng.choice(n, 3, replace=False)] = rng.standard_normal(3)
    return ref_csr.CSRMatrix.from_dense(dense)


def both(a, d, seed=3):
    x = np.random.default_rng(seed).standard_normal((a.n, d)).astype(
        np.float32)
    b = convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                               np.asarray(a.vals), device="cpu")
    return x, b, convert.dense_from_numpy(x, device="cpu")


@pytest.mark.parametrize("strategy", port_plan.STRATEGIES)
@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_staged_matches_reference_staged(fixture, backend, strategy):
    a = FIXTURES[fixture]()
    x, b, xt = both(a, 20)
    want = ref_spmm_mod.spmm(a, x, strategy=strategy, backend=backend,
                             interpret=True, staging="dma",
                             cache=RefJitCache())
    got = spmm_mod.spmm(b, xt, strategy=strategy, backend=backend,
                        device="cpu", staging="dma", cache=JitCache())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    resident = spmm_mod.spmm(b, xt, strategy=strategy, backend=backend,
                             device="cpu", staging="resident",
                             cache=JitCache())
    assert torch.equal(got, resident)


@pytest.mark.parametrize("backend,key", (("pallas_ell", "ell_fused"),
                                         ("pallas_bcsr", "bcsr_fused")))
def test_staged_forward_is_one_dma_dispatch(backend, key):
    _, b, xt = both(mixed_csr(seed=10), 16)
    c = spmm_mod.compile_spmm(b, 16, backend=backend, device="cpu",
                              staging="dma", cache=JitCache())
    assert c.staging == "dma"
    ops.reset_dispatch_counts()
    c(b.vals, xt)
    assert ops.DISPATCH_COUNTS[key] == 1
    assert ops.DISPATCH_COUNTS[key + "_dma"] == 1
    c_res = spmm_mod.compile_spmm(b, 16, backend=backend, device="cpu",
                                  staging="resident", cache=JitCache())
    ops.reset_dispatch_counts()
    c_res(b.vals, xt)
    assert ops.DISPATCH_COUNTS[key] == 1
    assert ops.DISPATCH_COUNTS[key + "_dma"] == 0


def test_auto_staging_resolves_per_device(monkeypatch):
    assert ops.resolve_staging(None, "cpu") == "resident"
    assert ops.resolve_staging("auto", "cpu") == "resident"
    assert ops.resolve_staging(None, "cuda:0") == "dma"
    assert ops.resolve_staging("auto", "cuda:1") == "dma"
    assert ops.resolve_staging("dma", "cpu") == "dma"
    assert ops.resolve_staging("resident", "cuda:0") == "resident"
    with pytest.raises(ValueError):
        ops.resolve_staging("mmap", "cpu")
    _, b, _ = both(mixed_csr(seed=11), 8)
    c = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                              cache=JitCache())
    assert c.staging == "resident"
    # on a card the default compile resolves to the staged kernels; a
    # CUDA artifact cannot be built here, so stand in for it
    monkeypatch.setattr(spmm_mod, "resolve_device", lambda device: "cuda:0")
    monkeypatch.setattr(spmm_mod, "CompiledSpmm",
                        lambda *args, **kw: ("artifact", kw["staging"]))
    art = spmm_mod.compile_spmm(b, 8, cache=JitCache())
    assert art == ("artifact", "dma")


def test_resident_and_dma_artifacts_never_share_a_key():
    _, b, _ = both(mixed_csr(seed=16), 8)
    cache = JitCache()
    c_res = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                                  staging="resident", cache=cache)
    c_dma = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                                  staging="dma", cache=cache)
    assert c_res is not c_dma
    assert cache.stats()["entries"] == 2
    assert spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                                 staging="dma", cache=cache) is c_dma
    assert spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                                 staging="auto", cache=cache) is c_res
    # the knob only exists on the fused dispatch
    with pytest.raises(ValueError):
        spmm_mod.compile_spmm(b, 8, backend="ref", device="cpu",
                              staging="dma", cache=JitCache())


def test_op_wrappers_refuse_dma_without_windows():
    a = mixed_csr(seed=20)
    x, b, xt = both(a, 8)
    c = spmm_mod.compile_spmm(b, 8, backend="pallas_ell", device="cpu",
                              staging="resident", cache=JitCache())
    operands, knobs = c.fused_operands(b.vals, xt)
    with pytest.raises(ValueError, match="windows"):
        ops.spmm_ell_fused_op(*operands, **knobs, staging="dma")
    with pytest.raises(ValueError, match="windows"):
        spmm_ell_fused_staged(*operands, **knobs, span=0, cspan=0)
    # auto without windows stays resident, and is right
    ops.reset_dispatch_counts()
    y = ops.spmm_ell_fused_op(*operands, **knobs)
    assert ops.DISPATCH_COUNTS["ell_fused_dma"] == 0
    want = ref_spmm_mod.spmm(a, x, backend="ref", cache=RefJitCache())
    np.testing.assert_allclose(y[c._fused.inv_perm, :8].numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


# -- the window arithmetic ---------------------------------------------------

def _tables(ws):
    return [torch.from_numpy(t).long() for t in
            (ws.blk_tag, ws.blk_off, ws.blk_coff, ws.blk_L)]


@pytest.mark.parametrize("cap", (None, 64, 200))
@pytest.mark.parametrize("merge_threshold", (0, 16))
@pytest.mark.parametrize("backend", FUSED)
def test_chunked_windows_are_bit_identical_on_a_hub_row(backend,
                                                        merge_threshold, cap):
    a = hub_csr()
    b = convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                               np.asarray(a.vals), device="cpu")
    ws, args = workspace(b, backend, merge_threshold, 20)
    t = torch_args(args)
    kw = dict(bm=8, mw=ws.merge_width)
    win = dict(span=ws.max_span, cspan=ws.max_cspan, cap=cap)
    if backend == "pallas_ell":
        want = call(spmm_ell_fused_plain, t, ELL, **kw)
        got = call(spmm_ell_fused_staged, t, ELL, **kw, **win)
        plain = call(spmm_ell_fused_staged_plain, t, ELL, **kw, **win)
    else:
        want = call(spmm_bcsr_fused_plain, t, BCSR, bk=8, **kw)
        got = call(spmm_bcsr_fused_staged, t, BCSR, bk=8, **kw, **win)
        plain = call(spmm_bcsr_fused_staged_plain, t, BCSR, bk=8, **kw,
                     **win)
    assert torch.equal(got, want) and torch.equal(plain, want)
    # the hub's window is over the slot, so the chunked walk ran
    c, ch, kc = k3_mod.staging_geometry(ws.max_span, ws.max_cspan, bm=8,
                                        bk=8, cap=cap)
    kinds = {it[0] for it in k3_mod.staged_walk(
        *_tables(ws), bm=8, bk=8, mw=ws.merge_width, c=c, ch=ch, kc=kc)}
    assert kinds & {"vpu", "mxu"}


@pytest.mark.parametrize("bm", (1, 2))
@pytest.mark.parametrize("backend", FUSED)
def test_staged_windows_off_the_16_byte_grid(backend, bm):
    """At bm < 4 slot windows start anywhere, so every copy goes
    through the aligned-down start and the remainder."""
    _, b, xt = both(hub_csr(seed=3), 20)
    c = spmm_mod.compile_spmm(b, 20, backend=backend, device="cpu", bm=bm,
                              staging="resident", cache=JitCache())
    ws = c.workspace
    assert np.any(ws.blk_off % 4)
    operands, knobs = c.fused_operands(b.vals, xt)
    if backend == "pallas_ell":
        plain, staged = spmm_ell_fused_plain, spmm_ell_fused_staged
    else:
        plain, staged = spmm_bcsr_fused_plain, spmm_bcsr_fused_staged
    want = plain(*operands, **knobs)
    for cap in (None, 64):
        got = staged(*operands, **knobs, span=ws.max_span,
                     cspan=ws.max_cspan, cap=cap)
        assert torch.equal(got, want), cap


@pytest.mark.parametrize("cap", (None, 64))
@pytest.mark.parametrize("backend", FUSED)
def test_staged_walk_windows_stay_in_bounds_and_cover_each_member(backend,
                                                                  cap):
    a = hub_csr(seed=1)
    b = convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                               np.asarray(a.vals), device="cpu")
    ws, _ = workspace(b, backend, 16, 20)
    bm, bk, mw = 8, 8, ws.merge_width
    tag, off, coff, L = _tables(ws)
    c, ch, kc = k3_mod.staging_geometry(ws.max_span, ws.max_cspan, bm=bm,
                                        bk=bk, cap=cap)
    assert c % 4 == 0 and ch % 4 == 0 and ch >= 4 and kc >= 1
    assert bm * (ch + 4) <= c + 4
    S, Sc = ws.gather_flat.shape[0], ws.cols_flat.shape[0]
    # the trips' own windows are the planner's blk_span/blk_cspan
    span, cspan = k3_mod.member_extents(tag, L, bm=bm, bk=bk)
    assert np.array_equal(span.view(-1, mw).sum(1).numpy(), ws.blk_span)
    assert np.array_equal(cspan.view(-1, mw).sum(1).numpy(), ws.blk_cspan)
    covered = {}
    for kind, i, s0, s1 in k3_mod.staged_walk(tag, off, coff, L, bm=bm,
                                              bk=bk, mw=mw, c=c, ch=ch,
                                              kc=kc):
        if kind == "trip":
            v0, c0 = int(off[i * mw]), int(coff[i * mw])
            segments = [(v0, s0, S), (c0, s1, Sc)]
        elif kind == "mxu":
            step = bm * bk
            segments = [(int(off[i]) + s0 * step, (s1 - s0) * step, S),
                        (int(coff[i]) + s0, s1 - s0, Sc)]
            covered.setdefault(i, []).append((s0, s1))
        else:
            segments = [(int(base[i]) + r * int(L[i]) + s0, s1 - s0, n)
                        for base, n in ((off, S), (coff, Sc))
                        for r in range(bm)]
            assert s1 - s0 <= ch
            covered.setdefault(i, []).append((s0, s1))
        for src, length, n in segments:
            if length == 0:
                continue        # nothing is copied
            a0, a1 = k3_mod.aligned(src, length)
            assert a0 % 4 == 0 and a1 % 4 == 0 and 0 <= a0 <= src
            assert a1 <= n, (kind, i, src, length, n)
            assert a1 - a0 <= (c + 4 if kind != "vpu" else ch + 4)
    assert covered, "the fixture must reach the chunked walk"
    for i, spans in covered.items():
        # a member's chunks tile its steps [0, L) in order
        ends = [s0 for s0, _ in spans] + [spans[-1][1]]
        assert ends[0] == 0 and ends[-1] == int(L[i])
        assert all(s1 == n0 for (_, s1), n0 in zip(spans, ends[1:]))


def test_copy_window_fills_only_the_aligned_span():
    stream = torch.arange(20, dtype=torch.float32)
    buf = k3_mod.copy_window(stream, 6, 5, 12, float("nan"))
    # entries [4, 12) copied; entry src + i lands at src % 4 + i
    assert torch.equal(buf[:8], stream[4:12])
    assert buf[8:].isnan().all()
    assert buf[6 % 4 + 2] == stream[8]
    with pytest.raises(IndexError):
        k3_mod.copy_window(stream, 17, 4, 12, 0.0)   # [16, 24) past 20
    with pytest.raises(IndexError):
        k3_mod.copy_window(stream, 1, 11, 8, 0.0)    # [0, 12) over 8
    assert k3_mod.aligned(6, 0) == (6, 6)


def test_staging_geometry_contract():
    c, ch, kc = k3_mod.staging_geometry(384, 384, bm=8, bk=8)
    assert (c, ch, kc) == (384, 44, 6)
    c, _, _ = k3_mod.staging_geometry(10 ** 6, 5, bm=8, bk=8)
    assert c == k3_mod.STAGE_CAP
    c, _, _ = k3_mod.staging_geometry(3, 3, bm=8, bk=8)
    assert c == 64           # at least one MXU step
    with pytest.raises(ValueError):
        k3_mod.staging_geometry(0, 128, bm=8)
    # 14 mbarriers, three slots of 388 entries a stream, four 4 KB X
    # stages
    assert k3_mod.ring_bytes(384, bm=8, bk=8) == (
        14 * 8 + 2 * 3 * 388 * 4 + 4 * 8 * 128 * 4)
    with pytest.raises(ValueError, match="exceeds"):
        k3_mod.check_staged(torch.zeros(8, 128), torch.zeros(4),
                            torch.zeros(4), c=20000, bm=8, bk=8)
