"""The port's fused sparse-attention sandwich (``compile_sparse_attention``,
K5/K6) against the reference's, on the CPU.

The same seeded masks and Q/K/V go through the reference (its Pallas
kernels in interpret mode) and the port (the kernels' plain versions):
plan tables and the Q row map ``np.array_equal``; forwards of every
backend and staging mode, and the gradients for the mask weights, Q, K
and V against ``jax.grad``, at rtol = atol = 1e-5 (the score sums may run
in another order).  Inside the port, merged equals unmerged and staged
equals resident bit for bit, as in the reference.  The CUDA kernels are
held to the plain versions by the ``cuda``-marked test in
``tests/test_torch_kernels.py``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_sparse_attention as ref_compile
from repro.core import csr as ref_csr
from repro.core.jit_cache import JitCache as RefJitCache
from repro.kernels.attn_fused import attn_fused as ref_attn_fused
from repro.kernels.attn_fused import attn_fused_staged as ref_attn_staged
from repro_torch import convert
from repro_torch.core import (chip_mesh, compile_sparse_attention,
                              sparse_attention)
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels import (attn_fused, attn_fused_plain,
                                 attn_fused_staged, attn_fused_staged_plain,
                                 ops)
from repro_torch.kernels.spmm_ell_fused import staged_walk, staging_geometry

spmm_mod = importlib.import_module("repro_torch.core.spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED = ("pallas_ell", "pallas_bcsr")
MODES = (("ref", "resident"), ("pallas_ell", "resident"),
         ("pallas_ell", "dma"), ("pallas_bcsr", "resident"),
         ("pallas_bcsr", "dma"))
TABLES = ("blk_tag", "blk_off", "blk_coff", "blk_L", "cols_flat",
          "gather_flat", "inv_perm")


def weighted(m=48, n=40, seed=3, density=0.15):
    """tests/test_attn_fused.py's ``_mask``: a powerlaw pattern with mask
    weights in [0.2, 2)."""
    s = ref_csr.random_csr(m, n, density=density, family="powerlaw",
                           seed=seed)
    vals = np.random.default_rng(seed + 1).uniform(0.2, 2.0, s.nnz)
    return ref_csr.CSRMatrix(s.shape, s.row_ptr, s.col_indices,
                             jnp.asarray(vals, jnp.float32))


def multi_trip():
    """tests/test_attn_fused.py's multi-trip fixture: a fully dense heavy
    row and a 40-wide one span many trips."""
    rng = np.random.default_rng(7)
    n = 64
    dense = np.zeros((24, n), np.float32)
    dense[0] = rng.uniform(0.2, 2.0, n)
    dense[1, :40] = rng.uniform(0.2, 2.0, 40)
    for i in range(2, 24):
        cols = rng.choice(n, size=rng.integers(1, 5), replace=False)
        dense[i, cols] = rng.uniform(0.2, 2.0, cols.size)
    return ref_csr.CSRMatrix.from_dense(dense)


def empty_rows():
    """tests/test_attn_fused.py's empty-rows fixture: rows 1 and 3 have
    no entries and must come out 0."""
    return ref_csr.CSRMatrix((4, 5), np.array([0, 2, 2, 3, 3], np.int64),
                             np.array([0, 3, 1], np.int32),
                             jnp.ones((3,), jnp.float32))


def over_cap(seed=5):
    """Windows over a small staging slot: a dense row, a dense 8-row
    block-row (tagged MXU) and a sparse tail."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((40, 96), np.float32)
    dense[3] = rng.uniform(0.2, 2.0, 96)
    dense[8:16, :64] = rng.uniform(0.2, 2.0, (8, 64))
    for i in range(16, 40):
        dense[i, rng.choice(96, size=2, replace=False)] = rng.uniform(0.2, 2.0,
                                                                      2)
    return ref_csr.CSRMatrix.from_dense(dense)


# name -> (mask, dh, dv, q scale)
FIXTURES = {
    "weighted": (weighted, 12, 20, 1.0),
    "multi_trip": (multi_trip, 8, 8, 12.0),
    "empty_rows": (empty_rows, 6, 6, 1.0),
}


def qkv(a, dh, dv, seed=4, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((a.m, dh)).astype(np.float32) * scale,
            rng.standard_normal((a.n, dh)).astype(np.float32),
            rng.standard_normal((a.n, dv)).astype(np.float32))


def port_mask(a):
    return convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                                  np.asarray(a.vals), device="cpu")


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def instance(name):
    make, dh, dv, scale = FIXTURES[name]
    a = make()
    return a, port_mask(a), dh, dv, qkv(a, dh, dv, scale=scale)


def ref_artifact(a, dh, dv, backend, staging="resident", **kw):
    if backend == "ref":
        return ref_compile(a, dh, dv, backend="ref", cache=RefJitCache(), **kw)
    return ref_compile(a, dh, dv, backend=backend, interpret=True,
                       staging=staging, cache=RefJitCache(), **kw)


def port_artifact(a, dh, dv, backend, staging="resident", **kw):
    return compile_sparse_attention(a, dh, dv, backend=backend,
                                    staging=staging, device="cpu",
                                    cache=JitCache(), **kw)


@pytest.mark.parametrize("merge_threshold", (0, 16))
@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("fixture", ("weighted", "multi_trip"))
def test_workspace_and_row_map_match_reference(fixture, backend,
                                               merge_threshold):
    a, pa, dh, dv, _ = instance(fixture)
    ref = ref_artifact(a, dh, dv, backend, merge_threshold=merge_threshold)
    got = port_artifact(pa, dh, dv, backend, merge_threshold=merge_threshold)
    for name in TABLES:
        assert np.array_equal(getattr(got.workspace, name),
                              getattr(ref.workspace, name)), name
    for name in ("num_blocks", "merge_width", "max_span", "max_cspan",
                 "ws_rows"):
        assert getattr(got.workspace, name) == getattr(ref.workspace, name)
    assert np.array_equal(got._row_map.numpy(), np.asarray(ref._row_map))


def test_fixtures_reach_mxu_merged_and_empty_rows():
    a, pa, dh, dv, _ = instance("weighted")
    ws = port_artifact(pa, dh, dv, "pallas_bcsr").workspace
    assert np.any(ws.blk_tag == 1) and np.any(ws.blk_tag == 0)
    assert port_artifact(pa, dh, dv, "pallas_ell",
                         merge_threshold=16).workspace.merge_width > 1
    assert np.any(instance("empty_rows")[0].row_lengths == 0)


@pytest.mark.parametrize("backend,staging", MODES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_forward_matches_reference(fixture, backend, staging):
    a, pa, dh, dv, (q, k, v) = instance(fixture)
    want = ref_artifact(a, dh, dv, backend, staging)(
        jnp.asarray(a.vals), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    c = port_artifact(pa, dh, dv, backend, staging)
    got = c(pa.vals, t(q), t(k), t(v))
    assert c.staging == staging
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if fixture == "empty_rows":
        assert torch.all(got[1] == 0) and torch.all(got[3] == 0)


@pytest.mark.parametrize("staging", ("resident", "dma"))
@pytest.mark.parametrize("merge_threshold", (0, 16))
@pytest.mark.parametrize("backend", FUSED)
def test_plain_kernels_match_reference_kernels(backend, merge_threshold,
                                               staging):
    """K5/K6's plain versions against the reference's Pallas kernels in
    interpret mode, on the same operands."""
    a, pa, dh, dv, (q, k, v) = instance("weighted")
    c = port_artifact(pa, dh, dv, backend, merge_threshold=merge_threshold)
    operands, knobs = c.fused_operands(pa.vals, t(q), t(k), t(v))
    j = [jnp.asarray(x.numpy()) for x in operands]
    if staging == "dma":
        win = dict(span=c.workspace.max_span, cspan=c.workspace.max_cspan)
        want = ref_attn_staged(*j, **knobs, **win, interpret=True)
        got = attn_fused_staged_plain(*operands, **knobs, **win)
    else:
        want = ref_attn_fused(*j, **knobs, interpret=True)
        got = attn_fused_plain(*operands, **knobs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", FUSED)
def test_merged_bit_matches_unmerged(backend):
    a = weighted(m=64, n=48, seed=13, density=0.08)
    pa = port_mask(a)
    q, k, v = (t(x) for x in qkv(a, 8, 8, seed=14))
    ys = [sparse_attention(pa, q, k, v, backend=backend, device="cpu",
                           merge_threshold=mt, cache=JitCache())
          for mt in (0, 16)]
    assert torch.equal(ys[0], ys[1])


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_dma_bit_matches_resident(fixture, backend):
    _, pa, dh, dv, (q, k, v) = instance(fixture)
    ys = [port_artifact(pa, dh, dv, backend, staging)(pa.vals, t(q), t(k),
                                                      t(v))
          for staging in ("resident", "dma")]
    assert torch.equal(ys[0], ys[1])


@pytest.mark.parametrize("backend", FUSED)
def test_staged_chunked_walk_bit_matches_resident(backend):
    """A 16-entry slot forces the chunked walk on the dense row and the
    dense block-row: the staged plain version still equals the resident
    one bit for bit, through NaN-filled buffers."""
    a = over_cap()
    pa = port_mask(a)
    q, k, v = (t(x) for x in qkv(a, 16, 16, seed=6))
    c = port_artifact(pa, 16, 16, backend)
    operands, knobs = c.fused_operands(pa.vals, q, k, v)
    ws = c.workspace
    want = attn_fused(*operands, **knobs)
    got = attn_fused_staged(*operands, **knobs, span=ws.max_span,
                            cspan=ws.max_cspan, cap=16)
    assert torch.equal(got, want)
    geo = staging_geometry(ws.max_span, ws.max_cspan, bm=c.bm, bk=c.bk,
                           cap=16)
    tables = [torch.from_numpy(x).long() for x in
              (ws.blk_tag, ws.blk_off, ws.blk_coff, ws.blk_L)]
    kinds = {it[0] for it in staged_walk(*tables, bm=c.bm, bk=c.bk,
                                         mw=ws.merge_width, c=geo[0],
                                         ch=geo[1], kc=geo[2])}
    # the mixed plan tags both dense parts MXU; the ELL plan has no MXU
    assert "trip" in kinds
    assert ("mxu" if backend == "pallas_bcsr" else "vpu") in kinds


@pytest.mark.parametrize("backend,staging", MODES)
def test_gradients_match_jax_grad(backend, staging):
    a = weighted(seed=11)
    pa = port_mask(a)
    q, k, v = qkv(a, 8, 12, seed=12)
    ref = ref_artifact(a, 8, 12, backend, staging)

    def f(w, qq, kk, vv):
        return jnp.sum(jnp.sin(ref(w, qq, kk, vv)))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        jnp.asarray(a.vals), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    inputs = [x.clone().requires_grad_(True)
              for x in (pa.vals, t(q), t(k), t(v))]
    c = port_artifact(pa, 8, 12, backend, staging)
    torch.sin(c(*inputs)).sum().backward()
    for name, x, w in zip(("vals", "q", "k", "v"), inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("backend", ("ref", "pallas_bcsr"))
def test_chunked_backward_equals_unchunked(backend, monkeypatch):
    a, pa, dh, dv, (q, k, v) = instance("multi_trip")

    def grads():
        inputs = [x.clone().requires_grad_(True)
                  for x in (pa.vals, t(q), t(k), t(v))]
        c = port_artifact(pa, dh, dv, backend)
        torch.sin(c(*inputs)).sum().backward()
        return c, [x.grad for x in inputs]

    _, whole = grads()
    # a few nonzeros per chunk: the 64-entry row is a chunk of its own
    monkeypatch.setattr(spmm_mod, "SDDMM_CHUNK", 3 * max(dh, dv))
    c, parts = grads()
    assert len(c.row_chunks()) > 8
    assert max(int(a.row_ptr[r1] - a.row_ptr[r0]) for r0, r1 in
               c.row_chunks() if r1 - r0 > 1) <= 3
    for g0, g1 in zip(whole, parts):
        assert torch.equal(g0, g1)


@pytest.mark.parametrize("backend", ("ref", "pallas_ell"))
@pytest.mark.parametrize("fixture", ("weighted", "multi_trip", "empty_rows"))
def test_instances_at_once_are_each_instance_alone(fixture, backend,
                                                   monkeypatch):
    """N instances in one call (the sattn layer's heads): each output and
    each Q/K/V gradient is that instance's alone bit for bit, the mask
    weights' gradient their sum; under a chunk of a few nonzeros too."""
    _, pa, dh, dv, _ = instance(fixture)
    rng = np.random.default_rng(21)
    n = 3
    qs, ks, vs = (t(rng.standard_normal((n, rows, w)))
                  for rows, w in ((pa.m, dh), (pa.n, dh), (pa.n, dv)))
    monkeypatch.setattr(spmm_mod, "SDDMM_CHUNK", 4 * max(dh, dv) * n)
    c = port_artifact(pa, dh, dv, backend)
    inputs = [x.clone().requires_grad_(True) for x in (pa.vals, qs, ks, vs)]
    y = c(*inputs)
    torch.sin(y).sum().backward()
    wsum = torch.zeros_like(pa.vals)
    for i in range(n):
        one = [x.clone().requires_grad_(True)
               for x in (pa.vals, qs[i], ks[i], vs[i])]
        yi = c(*one)
        torch.sin(yi).sum().backward()
        assert torch.equal(y[i], yi)
        for x, xi in zip(inputs[1:], one[1:]):
            assert torch.equal(x.grad[i], xi.grad)
        wsum += one[0].grad
    torch.testing.assert_close(inputs[0].grad, wsum, rtol=1e-6, atol=1e-6)


def test_backward_computes_only_requested_gradients():
    _, pa, dh, dv, (q, k, v) = instance("weighted")
    c = port_artifact(pa, dh, dv, "pallas_ell")
    qq = t(q).requires_grad_(True)
    torch.sin(c(pa.vals, qq, t(k), t(v))).sum().backward()
    assert qq.grad is not None and qq.grad.abs().sum() > 0
    assert c._ref_vjp(pa.vals, t(q), t(k), t(v), torch.ones(pa.m, dv),
                      (False,) * 4, torch.zeros(pa.m, dv)) == (None,) * 4


def test_jit_cache_key_separates_knobs():
    _, pa, _, _, _ = instance("weighted")
    cache = JitCache()

    def build(dh=8, dv=None, **kw):
        return compile_sparse_attention(pa, dh, dv, backend="pallas_ell",
                                        device="cpu", cache=cache, **kw)

    c0 = build()
    assert build() is c0
    distinct = [build(staging="dma"), build(sm_scale=1.0), build(8, 16),
                build(merge_threshold=16), build(bm=4), build(validate="off"),
                compile_sparse_attention(pa, 8, backend="pallas_bcsr",
                                         device="cpu", cache=cache),
                compile_sparse_attention(pa, 8, backend="pallas_bcsr",
                                         device="cpu", bk=4, cache=cache),
                build(strategy="row_split")]
    assert all(c is not c0 for c in distinct)
    assert len({id(c) for c in distinct}) == len(distinct)


@pytest.mark.parametrize("backend,staging", MODES[1:])
def test_one_dispatch_per_forward(backend, staging):
    _, pa, dh, dv, (q, k, v) = instance("weighted")
    for mt in (0, 16):
        c = port_artifact(pa, dh, dv, backend, staging, merge_threshold=mt)
        ops.reset_dispatch_counts()
        c(pa.vals, t(q), t(k), t(v))
        assert ops.DISPATCH_COUNTS["attn_fused"] == 1
        assert ops.DISPATCH_COUNTS["attn_fused_dma"] == (staging == "dma")
        assert ops.DISPATCH_COUNTS["attn_fused_merged"] == (
            c.workspace.merge_width > 1)
        assert ops.DISPATCH_COUNTS["sddmm"] == 0
    # a launch count moves only when a CUDA kernel is launched
    assert attn_fused.launches == attn_fused_staged.launches == 0


@pytest.mark.parametrize("bad", ("dense", "mesh", "n_chips", "ref_dma"))
def test_entry_points_refuse_what_they_do_not_run(bad):
    _, pa, dh, dv, (q, k, v) = instance("weighted")
    kw = dict(device="cpu", cache=JitCache())
    if bad == "dense":
        with pytest.raises(ValueError):
            compile_sparse_attention(pa, 8, backend="dense", **kw)
    elif bad == "ref_dma":
        with pytest.raises(ValueError):
            compile_sparse_attention(pa, 8, backend="ref", staging="dma",
                                     **kw)
    else:
        # the single-device ref backend refuses a mesh; the fused ones
        # run on a 2-chip CPU mesh, spelled either way, and equal the
        # unsharded forward bit for bit
        spelling = ({"mesh": chip_mesh(2, device="cpu")} if bad == "mesh"
                    else {"n_chips": 2})
        with pytest.raises(ValueError, match="single-device"):
            compile_sparse_attention(pa, 8, backend="ref", **spelling, **kw)
        for backend in FUSED:
            want = sparse_attention(pa, t(q), t(k), t(v), backend=backend,
                                    device="cpu", cache=JitCache())
            c = compile_sparse_attention(pa, dh, dv, backend=backend,
                                         device="cpu", cache=JitCache(),
                                         **spelling)
            assert c.n_chips == 2
            assert torch.equal(c(pa.vals, t(q), t(k), t(v)), want), backend


@pytest.mark.parametrize("bad", ("dtype", "bk", "width", "rows"))
def test_wrappers_reject_malformed_operands(bad):
    _, pa, dh, dv, (q, k, v) = instance("weighted")
    c = port_artifact(pa, dh, dv, "pallas_bcsr")
    operands, knobs = c.fused_operands(pa.vals, t(q), t(k), t(v))
    operands = list(operands)
    if bad == "dtype":
        operands[6] = operands[6].double()
    elif bad == "bk":
        knobs["bk"] = 64
    elif bad == "width":
        operands[8] = operands[8][:, :100].contiguous()
    else:
        operands[6] = operands[6][:-1]
    with pytest.raises(ValueError):
        attn_fused(*operands, **knobs)


def test_the_backward_of_a_chip_layer_dispatches_few_ops(monkeypatch):
    """The longformer layer's backward on one model chip's 8 (batch,
    head) instances, at S = 1024 and head width 16 with the chunk scaled
    so the mask takes as many chunks as at S = 4096 and width 128
    (2,193,696 nonzeros a head): 9 chunks,
    each a few dozen dispatches (the one host thread enqueues every
    card's).  Prints the count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.sparse_attention import sparse_attention_mask

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    S, hd, n = 1024, 16, 8
    a = sparse_attention_mask(S, 512, 64, device="cpu")
    # head width 16 for 128: the chunk scaled by both, so a chunk holds
    # the nonzeros it holds at full size
    monkeypatch.setattr(spmm_mod, "SDDMM_CHUNK", int(
        spmm_mod.SDDMM_CHUNK * a.row_ptr[-1] / 2_193_696 * hd / 128))
    # the backward is every backend's; ``ref``'s forward is the quickest
    c = compile_sparse_attention(a, hd, hd, backend="ref", device="cpu",
                                 cache=JitCache())
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(n, S, hd, generator=g).requires_grad_(True)
               for _ in range(3))
    y = c(a.vals, q, k, v)
    with Count():
        y.backward(torch.ones_like(y))
    chunks = len(c.row_chunks(n))
    print(f"{chunks} chunks, {Count.n} dispatches")
    assert chunks == 9
    assert Count.n <= 50 * chunks
