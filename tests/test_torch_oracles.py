"""K9 and K10, the micro-oracle kernels, and ``BCSRMatrix``, against the
reference.

On the CPU the port's ``spmm_ell_segment`` and ``spmm_bcsr`` run their
plain versions, held to the reference's Pallas kernels in interpret
mode and to both packages' ``ref.py`` oracles at rtol = atol = 1e-5 on
the same operands: K9 per segment of every strategy's plan and each
row block ``bm`` in {1, 2, 4, 8}, K10 on ``BCSRMatrix`` instances padded
to their global ``kmax``.  ``BCSRMatrix.from_csr`` builds the
reference's tables exactly.  The ``cuda``-marked tests hold each CUDA
kernel to its plain version on a Hopper card; a CUDA machine need not
have JAX, so the reference is imported inside the tests that use it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_oracles.py
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

import repro_torch.kernels as port_kernels
from repro_torch.core import BCSRMatrix, CSRMatrix, random_csr
from repro_torch.core import plan as port_plan
from repro_torch.kernels import (ops, ref, spmm_bcsr, spmm_bcsr_plain,
                                 spmm_ell_segment, spmm_ell_segment_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
port_bcsr = importlib.import_module("repro_torch.kernels.spmm_bcsr")


def mixed_dense(seed=0, m=48, n=64):
    """Dense banded block-rows plus 1-2 nonzero ragged rows, built like
    tests/test_bcsr_fused.py's ``_mixed_csr``."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(16):
        j0 = (i // 8) * 16
        dense[i, j0:j0 + 16] = rng.standard_normal(16)
    for i in range(16, m):
        k = rng.integers(1, 3)
        dense[i, rng.choice(n, size=k, replace=False)] = rng.standard_normal(k)
    return dense


FIXTURES = {
    "mixed": lambda: CSRMatrix.from_dense(mixed_dense(3), device="cpu"),
    "powerlaw": lambda: random_csr(40, 48, density=0.1, family="powerlaw",
                                   seed=4, device="cpu"),
    "banded": lambda: random_csr(61, 70, density=0.1, family="banded",
                                 seed=2, device="cpu"),
    "empty_matrix": lambda: CSRMatrix.from_dense(
        np.zeros((16, 24), np.float32), device="cpu"),
}
SEGMENT_FIXTURES = ("empty_matrix", "mixed", "powerlaw")
BCSR_FIXTURES = ("banded", "mixed", "powerlaw")


def x_for(n, d, rows=None, seed=1):
    x = np.zeros((n if rows is None else rows, d), np.float32)
    x[:n] = np.random.default_rng(seed).standard_normal((n, d))
    return x


def segment_operands(a, strategy, d=20, plan_mod=port_plan):
    """(cols_pad_flat, vals_pad, L) per segment of ``plan_mod``'s plan,
    and X padded to the plan's lane tile, as numpy."""
    plan = plan_mod.build_plan(a.row_ptr, a.col_indices, a.shape, d,
                               strategy=strategy)
    vals_ext = np.concatenate([a.vals.numpy(), [0.0]]).astype(np.float32)
    segs = [(s.cols_pad.reshape(-1), vals_ext[s.gather_idx], s.L)
            for s in plan.segments]
    return segs, x_for(a.n, plan.d_tiling.d_pad)


def reference_module(name=None):
    pytest.importorskip("jax")
    return importlib.import_module(
        "repro.kernels" if name is None else f"repro.kernels.{name}")


def test_segment_fixtures_reach_an_empty_segment():
    segs, _ = segment_operands(FIXTURES["empty_matrix"](), "row_split")
    assert [L for _, _, L in segs] == [0]


@pytest.mark.parametrize("bm", (1, 2, 4, 8))
@pytest.mark.parametrize("strategy", port_plan.STRATEGIES)
@pytest.mark.parametrize("fixture", SEGMENT_FIXTURES)
def test_segment_plain_matches_reference_kernel(fixture, strategy, bm):
    jnp = pytest.importorskip("jax.numpy")
    ref_seg = reference_module("spmm_csr")
    ref_oracles = reference_module("ref")
    from repro.core import plan as ref_plan
    a = FIXTURES[fixture]()
    segs, x = segment_operands(a, strategy)
    ref_segs, ref_x = segment_operands(a, strategy, plan_mod=ref_plan)
    np.testing.assert_array_equal(x, ref_x)
    assert len(segs) == len(ref_segs)
    for (cols, vals, L), (ref_cols, ref_vals, _) in zip(segs, ref_segs):
        np.testing.assert_array_equal(cols, ref_cols)
        np.testing.assert_array_equal(vals, ref_vals)
        want = np.asarray(ref_seg.spmm_ell_segment(
            jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x), bm=bm,
            interpret=True))
        want_ref = np.asarray(ref_oracles.spmm_ell_segment_ref(
            cols.reshape(vals.shape), jnp.asarray(vals), jnp.asarray(x)))
        got = spmm_ell_segment(torch.from_numpy(cols),
                               torch.from_numpy(vals), torch.from_numpy(x),
                               bm=bm)
        got_ref = ref.spmm_ell_segment_ref(cols.reshape(vals.shape),
                                           torch.from_numpy(vals),
                                           torch.from_numpy(x))
        assert got.shape == (vals.shape[0], x.shape[1])
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
        np.testing.assert_allclose(got_ref.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("bk", (4, 8))
@pytest.mark.parametrize("fixture", BCSR_FIXTURES)
def test_bcsr_tables_equal_the_reference(fixture, bk):
    pytest.importorskip("jax")
    from repro.core.csr import BCSRMatrix as RefBCSR
    from repro.core.csr import CSRMatrix as RefCSR
    a = FIXTURES[fixture]()
    ra = RefCSR(a.shape, a.row_ptr, a.col_indices, a.vals.numpy())
    want = RefBCSR.from_csr(ra, 8, bk)
    got = BCSRMatrix.from_csr(a, 8, bk)
    assert got.shape == want.shape and (got.bm, got.bk) == (8, bk)
    assert (got.n_block_rows, got.nblocks) == (want.n_block_rows,
                                               want.nblocks)
    np.testing.assert_array_equal(got.block_row_ptr, want.block_row_ptr)
    np.testing.assert_array_equal(got.block_cols, want.block_cols)
    assert got.block_row_ptr.dtype == want.block_row_ptr.dtype
    assert got.block_cols.dtype == want.block_cols.dtype
    assert got.block_vals.dtype == torch.float32
    np.testing.assert_array_equal(got.block_vals.numpy(),
                                  np.asarray(want.block_vals))


def test_kmax_padding_appends_zero_blocks_at_column_zero():
    b = BCSRMatrix.from_csr(FIXTURES["mixed"](), 8, 8)
    cols, vals, kmax = port_bcsr._pad_to_kmax(b)
    counts = np.diff(b.block_row_ptr)
    assert kmax == counts.max() and cols.dtype == torch.int32
    assert vals.shape == (b.n_block_rows * kmax, 8, 8)
    for i, c in enumerate(counts):
        lo = int(b.block_row_ptr[i])
        np.testing.assert_array_equal(cols[i * kmax:i * kmax + c].numpy(),
                                      b.block_cols[lo:lo + c])
        assert torch.equal(vals[i * kmax:i * kmax + c],
                           b.block_vals[lo:lo + c])
        assert not cols[i * kmax + c:(i + 1) * kmax].any()
        assert not vals[i * kmax + c:(i + 1) * kmax].any()
    assert counts.min() < kmax            # some block-row is padded


@pytest.mark.parametrize("d", (20, 128))
@pytest.mark.parametrize("fixture", BCSR_FIXTURES)
def test_bcsr_plain_matches_reference_kernel(fixture, d):
    jnp = pytest.importorskip("jax.numpy")
    ref_bcsr = reference_module("spmm_bcsr")
    ref_oracles = reference_module("ref")
    a = FIXTURES[fixture]()
    b = BCSRMatrix.from_csr(a, 8, 8)
    cols, vals, kmax = port_bcsr._pad_to_kmax(b)
    x = x_for(a.n, d, rows=b.shape[1])
    want = np.asarray(ref_bcsr.spmm_bcsr(
        jnp.asarray(cols.numpy()), jnp.asarray(vals.numpy()),
        jnp.asarray(x), kmax=kmax, interpret=True))
    want_ref = np.asarray(ref_oracles.spmm_bcsr_ref(
        b.block_row_ptr, b.block_cols, jnp.asarray(b.block_vals.numpy()),
        jnp.asarray(x), 8, 8))
    got = spmm_bcsr(cols, vals, torch.from_numpy(x), kmax=kmax)
    got_ref = ref.spmm_bcsr_ref(b.block_row_ptr, b.block_cols,
                                b.block_vals, torch.from_numpy(x), 8, 8)
    assert got.shape == (b.shape[0], d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, **TOL)
    # the blocks hold A: the product is A·X on the real rows
    dense = a.to_dense().numpy() @ x[:a.n]
    np.testing.assert_allclose(got.numpy()[:a.m], dense, rtol=1e-4,
                               atol=1e-4)


def test_ops_count_one_dispatch_per_call():
    a = FIXTURES["mixed"]()
    segs, x = segment_operands(a, "nnz_split")
    b = BCSRMatrix.from_csr(a, 8, 8)
    cols, vals, kmax = port_bcsr._pad_to_kmax(b)
    xb = torch.from_numpy(x_for(a.n, 16, rows=b.shape[1]))
    launches = (spmm_ell_segment.launches, spmm_bcsr.launches)
    ops.reset_dispatch_counts()
    for seg_cols, seg_vals, _ in segs:
        got = ops.spmm_ell_segment_op(torch.from_numpy(seg_cols),
                                      torch.from_numpy(seg_vals),
                                      torch.from_numpy(x), bm=4)
        want = spmm_ell_segment_plain(torch.from_numpy(seg_cols),
                                      torch.from_numpy(seg_vals),
                                      torch.from_numpy(x), bm=4)
        assert torch.equal(got, want)
    assert dict(ops.DISPATCH_COUNTS) == {"ell_segment": len(segs)}
    got = ops.spmm_bcsr_op(cols, vals, xb, kmax=kmax)
    assert torch.equal(got, spmm_bcsr_plain(cols, vals, xb, kmax=kmax))
    assert dict(ops.DISPATCH_COUNTS) == {"ell_segment": len(segs),
                                         "bcsr": 1}
    # a launch count moves only when a CUDA kernel is launched
    assert (spmm_ell_segment.launches, spmm_bcsr.launches) == launches


@pytest.mark.parametrize("bad", ("dtype", "bm", "length", "contiguity"))
def test_segment_rejects_malformed_operands(bad):
    segs, x = segment_operands(FIXTURES["mixed"](), "row_split")
    cols, vals, x = (torch.from_numpy(t) for t in (*segs[0][:2], x))
    bm = 8
    if bad == "dtype":
        vals = vals.double()
    elif bad == "bm":
        bm = 3
    elif bad == "length":
        cols = cols[:-1]
    else:
        x = x.t().contiguous().t()
    with pytest.raises(ValueError):
        spmm_ell_segment(cols, vals, x, bm=bm)


@pytest.mark.parametrize("bad", ("dtype", "kmax", "rows", "bm"))
def test_bcsr_rejects_malformed_operands(bad):
    b = BCSRMatrix.from_csr(FIXTURES["mixed"](), 8, 8)
    cols, vals, kmax = port_bcsr._pad_to_kmax(b)
    x = torch.from_numpy(x_for(b.shape[1], 16))
    if bad == "dtype":
        cols = cols.long()
    elif bad == "kmax":
        kmax += 1
    elif bad == "rows":
        x = x[:-1]
    else:
        vals = vals.reshape(-1, 16, 4)[:, :3].contiguous()
    with pytest.raises(ValueError):
        spmm_bcsr(cols, vals, x, kmax=kmax)


def test_only_the_sharded_wrappers_are_left_to_port():
    # nothing is left: every reference kernel export, the K8 sharded
    # wrappers included, has its port counterpart, and the port's extra
    # names are its plain versions
    reference = reference_module()
    missing = set(reference.__all__) - set(port_kernels.__all__)
    assert missing == set(), missing
    extra = set(port_kernels.__all__) - set(reference.__all__)
    assert all(name.endswith("_plain") for name in extra), extra
    for name in ("spmm_ell_fused_sharded", "spmm_bcsr_fused_sharded",
                 "attn_fused_sharded"):
        assert name + "_plain" in port_kernels.__all__, name


def _needs_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


@pytest.mark.cuda
def test_cuda_segment_kernel_matches_plain():
    _needs_hopper()
    for name, strategy, bm in itertools.product(
            SEGMENT_FIXTURES, port_plan.STRATEGIES, (1, 2, 4, 8)):
        segs, x = segment_operands(FIXTURES[name](), strategy)
        x = torch.from_numpy(x).cuda()
        for cols, vals, _ in segs:
            cols = torch.from_numpy(cols).cuda()
            vals = torch.from_numpy(vals).cuda()
            launches = spmm_ell_segment.launches
            got = spmm_ell_segment(cols, vals, x, bm=bm)
            want = spmm_ell_segment_plain(cols, vals, x, bm=bm)
            torch.cuda.synchronize()
            assert spmm_ell_segment.launches == launches + 1
            torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_cuda_bcsr_kernel_matches_plain():
    _needs_hopper()
    for name, d in itertools.product(BCSR_FIXTURES, (20, 128, 200)):
        a = FIXTURES[name]()
        b = BCSRMatrix.from_csr(a, 8, 8)
        cols, vals, kmax = (t.cuda() if isinstance(t, torch.Tensor) else t
                            for t in port_bcsr._pad_to_kmax(b))
        x = torch.from_numpy(x_for(a.n, d, rows=b.shape[1])).cuda()
        launches = spmm_bcsr.launches
        got = spmm_bcsr(cols, vals, x, kmax=kmax)
        want = spmm_bcsr_plain(cols, vals, x, kmax=kmax)
        torch.cuda.synchronize()
        assert spmm_bcsr.launches == launches + 1
        torch.testing.assert_close(got, want, **TOL)
