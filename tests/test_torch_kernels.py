"""K1/K2: the port's kernels against the reference's Pallas kernels.

On the CPU the port's wrappers run the plain PyTorch versions; these
are held to the reference's ``spmm_ell_fused`` / ``spmm_bcsr_fused`` in
interpret mode on identical workspaces (both tags, merged trips, L == 0
pad blocks) at rtol = atol = 1e-5: the same products summed in the same
per-row order, but the MXU step's dot product may sum in another order.

The CUDA kernels themselves are held to the plain versions by the
``cuda``-marked test, which runs only on a Hopper card.  A CUDA machine
need not have JAX, so this module imports the reference only inside the
tests that compare with it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import csr as port_csr
from repro_torch.core import plan as port_plan
from repro_torch.kernels import (spmm_bcsr_fused, spmm_bcsr_fused_plain,
                                 spmm_ell_fused, spmm_ell_fused_plain)

TOL = dict(rtol=1e-5, atol=1e-5)
ELL = ("blk_off", "blk_L", "cols_flat", "vals_flat", "x")
BCSR = ("blk_tag", "blk_off", "blk_coff", "blk_L", "cols_flat",
        "vals_flat", "x")


def mixed_dense(seed=0, m=48, n=64):
    """Dense banded block-rows (MXU bait) + 1-2 nnz ragged rows (VPU
    bait), built like tests/test_bcsr_fused.py's ``_mixed_csr``."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(16):
        j0 = (i // 8) * 16
        dense[i, j0:j0 + 16] = rng.standard_normal(16)
    for i in range(16, m):
        k = rng.integers(1, 3)
        dense[i, rng.choice(n, size=k, replace=False)] = rng.standard_normal(k)
    return dense


# host instances; random_csr and from_dense agree with the reference's
# byte for byte (tests/test_torch_plan.py)
FIXTURES = {
    "mixed": lambda: port_csr.CSRMatrix.from_dense(mixed_dense(3),
                                                   device="cpu"),
    "powerlaw": lambda: port_csr.random_csr(40, 48, density=0.1,
                                            family="powerlaw", seed=4,
                                            device="cpu"),
}


def workspace(a, backend, merge_threshold, d, plan_mod=port_plan):
    """``plan_mod``'s workspace for ``a`` as numpy kernel operands."""
    if backend == "pallas_bcsr":
        plan = plan_mod.build_mixed_plan(a.row_ptr, a.col_indices, a.shape, d)
    else:
        plan = plan_mod.build_plan(a.row_ptr, a.col_indices, a.shape, d)
    mw = plan_mod.choose_merge_width(a.row_ptr,
                                     merge_threshold=merge_threshold)
    ws = plan_mod.build_fused_workspace(plan, merge_width=mw)
    vals_ext = np.concatenate([a.vals.numpy(), [0.0]]).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((a.n, d)).astype(np.float32)
    x_pad = np.zeros((-(-a.n // 8) * 8, plan.d_tiling.d_pad), np.float32)
    x_pad[:a.n, :d] = x
    args = dict(blk_tag=ws.blk_tag, blk_off=ws.blk_off,
                blk_coff=ws.blk_coff, blk_L=ws.blk_L,
                cols_flat=ws.cols_flat, vals_flat=vals_ext[ws.gather_flat],
                x=x_pad)
    return ws, args


def call(fn, args, names, **kw):
    return fn(*[args[k] for k in names], **kw)


def torch_args(args, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in args.items()}


def reference_kernel(backend, args, ws):
    """The reference's Pallas kernel on ``args``, in interpret mode."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import plan as ref_plan
    from repro.kernels.spmm_bcsr_fused import spmm_bcsr_fused as ref_bcsr
    from repro.kernels.spmm_ell_fused import spmm_ell_fused as ref_ell
    assert ref_plan.MXU_TAG == port_plan.MXU_TAG
    j = {k: jnp.asarray(v) for k, v in args.items()}
    if backend == "pallas_ell":
        return np.asarray(call(ref_ell, j, ELL, bm=8,
                               mw=ws.merge_width, interpret=True))
    return np.asarray(call(ref_bcsr, j, BCSR, bm=8, bk=8,
                           mw=ws.merge_width, interpret=True))


def reference_workspace(a, backend, merge_threshold, d):
    pytest.importorskip("jax")
    from repro.core import plan as ref_plan
    return workspace(a, backend, merge_threshold, d, plan_mod=ref_plan)


@pytest.mark.parametrize("merge_threshold", (0, 16))
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_ell_plain_matches_reference_kernel(fixture, merge_threshold):
    ws, args = reference_workspace(FIXTURES[fixture](), "pallas_ell",
                                   merge_threshold, 20)
    want = reference_kernel("pallas_ell", args, ws)
    got = call(spmm_ell_fused_plain, torch_args(args), ELL, bm=8,
               mw=ws.merge_width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("merge_threshold", (0, 16))
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_bcsr_plain_matches_reference_kernel(fixture, merge_threshold):
    ws, args = reference_workspace(FIXTURES[fixture](), "pallas_bcsr",
                                   merge_threshold, 20)
    assert ws.has_mxu and np.any(ws.blk_tag == port_plan.VPU_TAG)
    want = reference_kernel("pallas_bcsr", args, ws)
    got = call(spmm_bcsr_fused_plain, torch_args(args), BCSR, bm=8, bk=8,
               mw=ws.merge_width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fixtures_reach_merged_trips_and_pad_blocks():
    ws, _ = workspace(FIXTURES["mixed"](), "pallas_bcsr", 16, 20)
    assert ws.merge_width > 1 and np.any(ws.blk_L == 0)


def test_wrappers_run_plain_version_on_cpu_tensors():
    a = FIXTURES["mixed"]()
    ws, args = workspace(a, "pallas_bcsr", 16, 20)
    t = torch_args(args)
    got = call(spmm_bcsr_fused, t, BCSR, bm=8, bk=8, mw=ws.merge_width)
    want = call(spmm_bcsr_fused_plain, t, BCSR, bm=8, bk=8,
                mw=ws.merge_width)
    assert torch.equal(got, want)
    before = (spmm_ell_fused.launches, spmm_bcsr_fused.launches)
    ws, args = workspace(a, "pallas_ell", 0, 20)
    call(spmm_ell_fused, torch_args(args), ELL, bm=8, mw=ws.merge_width)
    # a launch count moves only when a CUDA kernel is launched
    assert (spmm_ell_fused.launches, spmm_bcsr_fused.launches) == before


@pytest.mark.parametrize("bad", ("dtype", "contiguity", "merge", "bm",
                                 "rows"))
def test_wrappers_reject_malformed_operands(bad):
    ws, args = workspace(FIXTURES["mixed"](), "pallas_bcsr", 0, 20)
    t = torch_args(args)
    kw = dict(bm=8, bk=8, mw=1)
    if bad == "dtype":
        t["blk_off"] = t["blk_off"].long()
    elif bad == "contiguity":
        t["x"] = t["x"].t().contiguous().t()
    elif bad == "merge":
        kw["mw"] = ws.num_blocks + 1
    elif bad == "bm":
        kw["bm"] = 3
    else:
        t["x"] = t["x"][:-1]
    with pytest.raises(ValueError):
        call(spmm_bcsr_fused, t, BCSR, **kw)


@pytest.mark.parametrize("oracle", ("csr", "dense"))
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_oracles_match_reference_oracles(fixture, oracle):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as ref_oracles
    from repro_torch.kernels import ref as port_oracles
    a = FIXTURES[fixture]()
    x = np.random.default_rng(5).standard_normal((a.n, 20)).astype(
        np.float32)
    if oracle == "csr":
        want = ref_oracles.spmm_csr_ref(a.row_ptr, a.col_indices,
                                        jnp.asarray(a.vals.numpy()),
                                        jnp.asarray(x), a.m)
        got = port_oracles.spmm_csr_ref(a.row_ptr, a.col_indices, a.vals,
                                        torch.from_numpy(x), a.m)
    else:
        dense = a.to_dense()
        want = ref_oracles.spmm_dense_ref(jnp.asarray(dense.numpy()),
                                          jnp.asarray(x))
        got = port_oracles.spmm_dense_ref(dense, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # full-fp32 plain bmm
    for fixture, merge_threshold, d in itertools.product(
            sorted(FIXTURES), (0, 16), (16, 100, 640)):
        a = FIXTURES[fixture]()
        for backend, fn, plain, names in (
                ("pallas_ell", spmm_ell_fused, spmm_ell_fused_plain, ELL),
                ("pallas_bcsr", spmm_bcsr_fused, spmm_bcsr_fused_plain,
                 BCSR)):
            ws, args = workspace(a, backend, merge_threshold, d)
            t = torch_args(args, "cuda")
            kw = dict(bm=8, mw=ws.merge_width)
            if backend == "pallas_bcsr":
                kw["bk"] = 8
            launches = fn.launches
            got = call(fn, t, names, **kw)
            want = call(plain, t, names, **kw)
            torch.cuda.synchronize()
            assert fn.launches == launches + 1
            torch.testing.assert_close(got, want, **TOL)
