"""K1's two routes (``kernels/spmm_ell_fused.py``): the gather ring at
planned widths, the width-fitted one-thread-a-column body elsewhere.

On the CPU: the route predicate and the narrow CTA's width against the
rule the launcher in ``csrc/spmm_ell_fused.cu`` enforces, the ring's
stage geometry and shared memory against the constants of
``csrc/spmm_gather_ring.cuh`` (as ``tests/test_torch_gather_ring.py``
does for K2-K4), and the wrapper at a width of each route held to the
reference's ``spmm_ell_fused`` in interpret mode at rtol = atol = 1e-5
at every supported ``bm``.  The ``cuda``-marked test holds both routes
to the plain version and to K3 bit for bit on a Hopper card; a CUDA
machine need not have JAX, so the reference is imported inside the
tests that use it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_k1_route.py
"""
import importlib
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import csr as port_csr
from repro_torch.core import plan as port_plan

k1 = importlib.import_module("repro_torch.kernels.spmm_ell_fused")

CSRC = Path(k1.__file__).parent / "csrc"
HEADER = CSRC / "spmm_gather_ring.cuh"
LAUNCHER = CSRC / "spmm_ell_fused.cu"
TOL = dict(rtol=1e-5, atol=1e-5)
# a width under 128, a planned one, one over 128 that is not planned
WIDTHS = (47, 128, 200)


def header_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert found, f"{name} is not defined in {HEADER.name}"
    return int(found.group(1))


def launcher_accepts(threads: int) -> bool:
    """The narrow launch's check in ``spmm_ell_fused.cu``, in Python."""
    return 0 < threads <= NARROW_MAX and threads % 32 == 0


NARROW_MAX = int(re.search(r"constexpr int kNarrowThreads = (\d+);",
                           LAUNCHER.read_text()).group(1))


@pytest.mark.parametrize("d_pad", (1, 20, 32, 33, 47, 64, 65, 100, 127,
                                   128, 129, 200, 255, 256, 257, 300, 384,
                                   640, 1000))
def test_route_and_narrow_threads(d_pad):
    assert k1.ring_route(d_pad) == (d_pad % 128 == 0)
    assert k1.NARROW_MAX_THREADS == NARROW_MAX
    threads = k1.narrow_threads(d_pad)
    if d_pad <= NARROW_MAX:
        # one CTA a trip, whole warps of the width: no warp of it idles
        assert threads == 32 * -(-d_pad // 32) and threads - d_pad < 32
    else:
        assert threads == 128
    assert launcher_accepts(threads)
    # the launch's tiles of `threads` columns cover the width
    tiles = -(-d_pad // threads)
    assert (tiles - 1) * threads < d_pad <= tiles * threads


def test_no_route_below_one_column():
    assert not k1.ring_route(0)


def test_mirror_constants_match_the_source():
    assert k1.STAGE_ROWS == header_constant("kStageRows")
    assert k1.X_STAGES == header_constant("kXStages")
    assert k1.RING_SLOTS == header_constant("kSlots")
    assert k1.COL_TILE == 128
    text = HEADER.read_text()
    assert "struct EllStages" in text and "ell_ring_bytes" in text
    launcher = LAUNCHER.read_text()
    # threads == 0 is the ring, sized by its stage's rows
    assert "if (threads == 0)" in launcher
    assert "p.bk = spmm_ring::ell_rows(BM)" in launcher
    assert "spmm_ring::EllStages" in launcher
    assert "threads > kNarrowThreads || threads % 32" in launcher
    assert "(d_pad + threads - 1) / threads" in launcher
    assert "blockIdx.y * blockDim.x + threadIdx.x" in launcher
    # the wrapper's argument list matches the launcher's
    args = re.search(r"spmm_ell_fused_launch\((.*?)\)", launcher,
                     re.S).group(1)
    assert args.count("void*") == 7 and args.count("int ") == 5
    assert len(k1._ARGTYPES) == 12


@pytest.mark.parametrize("bm", k1.SUPPORTED_BM)
def test_ring_stage_geometry(bm):
    g = k1.resident_geometry(bm=bm)
    rows, steps = g["rows"], g["steps"]
    # at least 8 rows a stage, whole steps of one descriptor, and a
    # stage's slots held one a lane of the producer warp
    assert rows >= header_constant("kStageRows") and rows >= bm
    assert steps * bm == rows and steps >= 1
    assert rows <= 32
    assert rows == max(8, bm)


@pytest.mark.parametrize("bm", k1.SUPPORTED_BM)
def test_ring_bytes_fit_a_cta(bm):
    slots, stages = header_constant("kSlots"), header_constant("kXStages")
    rows = k1.resident_geometry(bm=bm)["rows"]
    # every barrier of the ring, then the stages: rows of 128 floats
    # and the rows' values in whole 16-byte units
    want = 2 * (slots + stages) * 8 + stages * (rows * 128
                                                + -(-rows // 4) * 4) * 4
    got = k1.resident_ring_bytes(bm=bm)
    assert got == want and got % 16 == 0
    assert got <= k1.MAX_SHARED_BYTES
    # the stages start on a 16-byte boundary after the barriers
    assert 2 * (slots + stages) * 8 % 16 == 0


def mixed_dense(seed=0, m=48, n=64):
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
    "mixed": lambda: port_csr.CSRMatrix.from_dense(mixed_dense(3),
                                                   device="cpu"),
    "powerlaw": lambda: port_csr.random_csr(40, 48, density=0.1,
                                            family="powerlaw", seed=4,
                                            device="cpu"),
}


def operands(a, bm, merge_threshold, d, plan_mod=port_plan):
    """K1's operands for ``a`` at row block ``bm``, X of width ``d`` as
    given (a direct call), as numpy; and the workspace."""
    plan = plan_mod.build_plan(a.row_ptr, a.col_indices, a.shape, 20,
                               row_block=bm)
    mw = plan_mod.choose_merge_width(a.row_ptr, row_block=bm,
                                     merge_threshold=merge_threshold)
    ws = plan_mod.build_fused_workspace(plan, merge_width=mw)
    vals_ext = np.concatenate([a.vals.numpy(), [0.0]]).astype(np.float32)
    x = np.random.default_rng(d).standard_normal((a.n, d)).astype(np.float32)
    return ws, [ws.blk_off, ws.blk_L, ws.cols_flat,
                vals_ext[ws.gather_flat], x]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("bm", k1.SUPPORTED_BM)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_wrapper_matches_reference_kernel_at_each_route(fixture, bm, d):
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import plan as ref_plan
    from repro.kernels.spmm_ell_fused import spmm_ell_fused as ref_ell
    a = FIXTURES[fixture]()
    ws, ops = operands(a, bm, 16, d)
    ref_ws, ref_ops = operands(a, bm, 16, d, plan_mod=ref_plan)
    for got_t, want_t in zip(ops, ref_ops):
        np.testing.assert_array_equal(got_t, want_t)
    want = np.asarray(ref_ell(*map(jnp.asarray, ref_ops), bm=bm,
                              mw=ref_ws.merge_width, interpret=True))
    got = k1.spmm_ell_fused(*map(torch.from_numpy, ops), bm=bm,
                            mw=ws.merge_width)
    assert got.shape == (ws.num_blocks * bm, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- on the card ------------------------------------------------------------

def _needs_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


@pytest.mark.cuda
def test_cuda_both_routes_equal_plain_and_k3():
    _needs_hopper()
    routes = set()
    for (name, make), bm, mt, d in itertools.product(
            FIXTURES.items(), k1.SUPPORTED_BM, (0, 16), WIDTHS + (256,)):
        ws, ops = operands(make(), bm, mt, d)
        t = [torch.from_numpy(np.ascontiguousarray(o)).cuda() for o in ops]
        knobs = dict(bm=bm, mw=ws.merge_width)
        launches = k1.spmm_ell_fused.launches
        got = k1.spmm_ell_fused(*t, **knobs)
        want = k1.spmm_ell_fused_plain(*t, **knobs)
        torch.cuda.synchronize()
        assert k1.spmm_ell_fused.launches == launches + 1
        assert torch.equal(got, want), (name, bm, mt, d)
        # K3 takes whole column tiles: X padded, the result cut back
        tiles = -(-d // 128) * 128
        x3 = torch.nn.functional.pad(t[4], (0, tiles - d))
        y3 = k1.spmm_ell_fused_staged(*t[:4], x3, span=ws.max_span,
                                      cspan=ws.max_cspan, **knobs)
        assert torch.equal(y3[:, :d], got), (name, bm, mt, d)
        routes.add(k1.ring_route(d))
    assert routes == {True, False}
