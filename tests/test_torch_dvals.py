"""The SpMM backward's dvals through K7, and K9's descriptor tables.

On the fused backends ``CompiledSpmm._sddmm`` runs ``kernels.sddmm`` (K7)
over (row, col) pairs that the artifact builds once and keeps on its
device; on the CPU that is K7's plain version, which these tests count,
and a second backward does no host work for them.  dvals are held to
``jax.grad`` of the reference's ``compile_spmm`` (its Pallas backends in
interpret mode) at rtol = atol = 1e-5, at the GCN's widths 47 and 128,
on a structure with empty rows.  K9 runs on the gather ring over the
descriptor table ``segment_tables`` writes out, which must be the
implicit table its plain version walks.  The ``cuda``-marked tests hold
the card's K7 and K9 to their plain versions, K9 to K1 bit for bit, and
the card's dvals to the ``ref`` backend's:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_dvals.py
"""
import importlib
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import CSRMatrix, compile_spmm, random_csr
from repro_torch.core.jit_cache import JitCache
from repro_torch.core.plan import STRATEGIES, build_plan
from repro_torch.kernels import (ops, sddmm, sddmm_plain, spmm_ell_segment,
                                 spmm_ell_segment_plain)
from repro_torch.kernels.spmm_ell_fused import SUPPORTED_BM

spmm_mod = importlib.import_module("repro_torch.core.spmm")
sddmm_mod = importlib.import_module("repro_torch.kernels.sddmm")
segment_mod = importlib.import_module("repro_torch.kernels.spmm_csr")

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED = (("pallas_ell", "resident"), ("pallas_ell", "dma"),
         ("pallas_bcsr", "resident"), ("pallas_bcsr", "dma"))


def empty_rows_numpy(seed=1):
    """A dense 300 x 256 array with up to 5 nonzeros a row and every
    seventh row empty."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((300, 256), np.float32)
    for i in range(300):
        k = int(rng.integers(0, 6)) if i % 7 else 0
        dense[i, rng.choice(256, size=k, replace=False)] = (
            rng.standard_normal(k))
    return dense


def port_dvals(dense, d, backend, staging, g, x, cache=None):
    a = CSRMatrix.from_dense(dense, device="cpu")
    c = compile_spmm(a, d, backend=backend, staging=staging, device="cpu",
                     cache=cache or JitCache())
    vals = a.vals.clone().requires_grad_(True)
    (c(vals, torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    return c, vals.grad


class PlainCalls:
    """Counts the calls of K7's plain version."""

    def __init__(self, monkeypatch):
        self.calls = 0
        orig = sddmm_mod.sddmm_plain

        def counted(*args, **kw):
            self.calls += 1
            return orig(*args, **kw)
        monkeypatch.setattr(sddmm_mod, "sddmm_plain", counted)


@pytest.mark.parametrize("backend,staging", FUSED)
def test_fused_dvals_run_k7_once_a_backward(backend, staging, monkeypatch):
    dense = empty_rows_numpy()
    rng = np.random.default_rng(2)
    g = rng.standard_normal((300, 16)).astype(np.float32)
    x = rng.standard_normal((256, 16)).astype(np.float32)
    plain = PlainCalls(monkeypatch)
    ops.reset_dispatch_counts()
    c, dvals = port_dvals(dense, 16, backend, staging, g, x)
    assert plain.calls == 1
    # as in the reference, the backward dispatches no "sddmm"
    assert ops.DISPATCH_COUNTS["sddmm"] == 0
    rows, cols = c._sddmm_pairs()
    want = sddmm_plain(rows, cols, torch.from_numpy(g),
                       torch.from_numpy(x), T=spmm_mod.SDDMM_T)
    assert torch.equal(dvals, want[:c._col_indices.shape[0]])


@pytest.mark.parametrize("backend", ("ref", "dense"))
def test_plain_backends_keep_the_torch_sddmm(backend, monkeypatch):
    dense = empty_rows_numpy()
    rng = np.random.default_rng(3)
    g = rng.standard_normal((300, 8)).astype(np.float32)
    x = rng.standard_normal((256, 8)).astype(np.float32)
    plain = PlainCalls(monkeypatch)
    c, dvals = port_dvals(dense, 8, backend, "resident", g, x)
    assert plain.calls == 0 and c._pairs is None
    r, k = np.nonzero(dense)
    np.testing.assert_allclose(dvals.numpy(), (g[r] * x[k]).sum(-1), **TOL)


def test_pairs_are_built_once_and_padded_to_the_pair_group(monkeypatch):
    dense = empty_rows_numpy(seed=4)
    rng = np.random.default_rng(5)
    g = rng.standard_normal((300, 24)).astype(np.float32)
    x = rng.standard_normal((256, 24)).astype(np.float32)
    c, first = port_dvals(dense, 24, "pallas_bcsr", None, g, x)
    rows, cols = c._sddmm_pairs()
    nnz = int(np.count_nonzero(dense))
    T = spmm_mod.SDDMM_T
    assert rows.dtype == cols.dtype == torch.int32
    assert rows.shape == cols.shape == (-(-nnz // T) * T,)
    r, k = np.nonzero(dense)
    np.testing.assert_array_equal(rows[:nnz].numpy(), r)
    np.testing.assert_array_equal(cols[:nnz].numpy(), k)
    assert not rows[nnz:].any() and not cols[nnz:].any()
    # a second backward: no numpy in the artifact, the same pairs
    monkeypatch.setattr(spmm_mod, "np", None)
    a = CSRMatrix.from_dense(dense, device="cpu")
    vals = a.vals.clone().requires_grad_(True)
    (c(vals, torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    assert c._sddmm_pairs()[0] is rows
    assert torch.equal(vals.grad, first)


@pytest.mark.parametrize("d", (47, 128))
@pytest.mark.parametrize("backend,staging", FUSED)
def test_dvals_match_jax_grad(backend, staging, d):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.core import csr as ref_csr
    from repro.core.jit_cache import JitCache as RefJitCache
    ref_spmm_mod = importlib.import_module("repro.core.spmm")
    dense = empty_rows_numpy(seed=6)
    assert (np.count_nonzero(dense, axis=1) == 0).any()
    rng = np.random.default_rng(7)
    g = rng.standard_normal((300, d)).astype(np.float32)
    x = rng.standard_normal((256, d)).astype(np.float32)
    a = ref_csr.CSRMatrix.from_dense(dense)
    c_ref = ref_spmm_mod.compile_spmm(a, d, backend=backend, interpret=True,
                                      staging=staging, cache=RefJitCache())
    want = jax.grad(lambda v: jnp.sum(c_ref(v, jnp.asarray(x)) * g))(
        jnp.asarray(a.vals))
    b = convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                               np.asarray(a.vals), device="cpu")
    c = compile_spmm(b, d, backend=backend, staging=staging, device="cpu",
                     cache=JitCache())
    vals = b.vals.clone().requires_grad_(True)
    (c(vals, torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(want), **TOL)


def test_k7_ring_mirror_matches_the_source():
    src = (Path(sddmm_mod.__file__).parent / "csrc" / "sddmm.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert (sddmm_mod.RING_WARPS, sddmm_mod.RING_STAGES) == (
        constant("kWarps"), constant("kStages"))
    assert "return nj == 16 ? 2048 : 1024;" in src
    # 3 CTAs of 8 warps fit an SM's 228 KB below 512-wide tiles, 1 there
    assert [sddmm_mod.ring_bytes(nj) for nj in (1, 2, 4, 8, 16)] == (
        [65536] * 4 + [131072])


@pytest.mark.parametrize("bm", SUPPORTED_BM)
@pytest.mark.parametrize("R_blocks,L", ((1, 0), (3, 1), (5, 7), (16, 40)))
def test_segment_tables_are_the_implicit_table(R_blocks, L, bm):
    off, steps = segment_mod.segment_tables(R_blocks * bm, L, bm=bm,
                                            device="cpu")
    assert off.dtype == steps.dtype == torch.int32
    assert off.tolist() == [i * bm * L for i in range(R_blocks)]
    assert steps.tolist() == [L] * R_blocks


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_segment_plain_walks_its_tables(strategy):
    # the plain version over the written-out table equals row r's slots
    # summed in slot order, one rounding for each product and each sum
    a = random_csr(96, 80, density=0.08, family="powerlaw", seed=8,
                   device="cpu")
    plan = build_plan(a.row_ptr, a.col_indices, a.shape, 20,
                      strategy=strategy)
    x = torch.randn(a.n, plan.d_tiling.d_pad,
                    generator=torch.Generator().manual_seed(9))
    vals_ext = torch.cat([a.vals, a.vals.new_zeros(1)])
    for seg in plan.segments:
        cols = torch.from_numpy(seg.cols_pad.reshape(-1))
        vals = vals_ext[torch.from_numpy(seg.gather_idx)]
        got = spmm_ell_segment_plain(cols, vals, x, bm=8)
        want = torch.zeros_like(got)
        for s in range(seg.L):
            k = cols.view(-1, seg.L)[:, s].long()
            want = want + vals[:, s, None] * x[k]
        assert torch.equal(got, want)


# -- on the card ------------------------------------------------------------

def _needs_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("d", (47, 100, 128, 256, 1040))
def test_cuda_k7_matches_plain_at_every_tile_shape(d):
    # one tile of 47, 100, 128 or 256 (1 to 8 elements a lane) and 65
    # tiles of 16 (half the lanes idle); two 512-wide tiles are held bit
    # for bit to the one-warp-a-pair kernel by chip_smoke --ab-parent
    _needs_hopper()
    a = random_csr(500, 400, density=0.04, family="powerlaw", seed=d)
    gen = torch.Generator(device="cuda").manual_seed(d)
    dy = torch.randn(a.m, d, device="cuda", generator=gen)
    x = torch.randn(a.n, d, device="cuda", generator=gen)
    for T in (8, 128):
        rows, cols, _, _ = sddmm_mod._csr_pairs(a, dy, x, T=T,
                                                device="cuda:0")
        launches = sddmm.launches
        got = sddmm(rows, cols, dy, x, T=T)
        want = sddmm_plain(rows, cols, dy, x, T=T)
        torch.cuda.synchronize()
        assert sddmm.launches == launches + 1
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_cuda_k9_matches_plain_and_k1_at_every_bm():
    _needs_hopper()
    gen = torch.Generator(device="cuda").manual_seed(10)
    a = random_csr(300, 256, density=0.05, family="powerlaw", seed=11)
    for strategy, bm, d in itertools.product(STRATEGIES, SUPPORTED_BM,
                                             (20, 128, 200)):
        c = compile_spmm(a, d, backend="pallas_ell", staging="resident",
                         strategy=strategy, bm=bm, cache=JitCache())
        x = torch.randn(a.n, d, device="cuda", generator=gen)
        x_pad = torch.nn.functional.pad(x, (0, c.d_tiling.d_pad - d))
        vals_ext = torch.cat([a.vals, a.vals.new_zeros(1)])
        y = torch.zeros((a.m, d), device="cuda")
        for seg in c.plan.segments:
            cols = torch.from_numpy(seg.cols_pad.reshape(-1)).cuda()
            vals = vals_ext[torch.from_numpy(seg.gather_idx).cuda()]
            launches = spmm_ell_segment.launches
            got = spmm_ell_segment(cols, vals, x_pad, bm=bm)
            assert spmm_ell_segment.launches == launches + 1
            want = spmm_ell_segment_plain(cols, vals, x_pad, bm=bm)
            torch.testing.assert_close(got, want, **TOL)
            if bm == 8:     # an unplanned width, padded by the wrapper
                assert torch.equal(spmm_ell_segment(cols, vals, x),
                                   got[:, :d])
            y[torch.from_numpy(seg.row_ids).cuda()] = got[:seg.R, :d]
        assert torch.equal(y, c(a.vals, x)), (strategy, bm, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", (47, 128))
def test_cuda_dvals_launch_k7_and_match_ref(d):
    _needs_hopper()
    a = random_csr(2000, 1500, density=0.01, family="powerlaw", seed=12)
    gen = torch.Generator(device="cuda").manual_seed(13)
    g = torch.randn(a.m, d, device="cuda", generator=gen)
    x = torch.randn(a.n, d, device="cuda", generator=gen)
    grads = []
    for backend in ("auto", "ref"):
        c = compile_spmm(a, d, backend=backend, cache=JitCache())
        vals = a.vals.clone().requires_grad_(True)
        launches = sddmm.launches
        (c(vals, x) * g).sum().backward()
        torch.cuda.synchronize()
        assert sddmm.launches == launches + (backend == "auto")
        grads.append(vals.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)
