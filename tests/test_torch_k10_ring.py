"""K10 (``kernels/spmm_bcsr.py``) on K2's gather ring: block-row ``i``
of a ``BCSRMatrix`` padded to its global ``kmax`` is one MXU descriptor
of K2's, with the implicit table ``bcsr_tables`` writes out and the
ring's ``BlockRows`` source computes from ``i``.

On the CPU: the route predicate, the ring's stage geometry and shared
memory against the constants of ``csrc/spmm_gather_ring.cuh``, the
table walked by K2's plain version
equal bit for bit to K10's plain version, and K10 held to the
reference's ``spmm_bcsr`` in interpret mode at rtol = atol = 1e-5, over
every fixture x bm {1, 8, 16} x bk {1, 4, 8} x d {20, 47, 128, 200}.
The ``cuda``-marked test holds both routes to the plain version bit for
bit on a Hopper card; a CUDA machine need not have JAX, so the
reference is imported inside the test that uses it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_k10_ring.py
"""
import importlib
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BCSRMatrix, CSRMatrix, random_csr
from repro_torch.kernels import spmm_bcsr_fused_plain

k10 = importlib.import_module("repro_torch.kernels.spmm_bcsr")
k2 = importlib.import_module("repro_torch.kernels.spmm_bcsr_fused")

CSRC = Path(k10.__file__).parent / "csrc"
TOL = dict(rtol=1e-5, atol=1e-5)
BMS, BKS, WIDTHS = (1, 8, 16), (1, 4, 8), (20, 47, 128, 200)


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
    "mixed": lambda: CSRMatrix.from_dense(mixed_dense(3), device="cpu"),
    "powerlaw": lambda: random_csr(40, 48, density=0.1, family="powerlaw",
                                   seed=4, device="cpu"),
    "banded": lambda: random_csr(61, 70, density=0.1, family="banded",
                                 seed=2, device="cpu"),
}


def operands(fixture, bm, bk, d):
    """K10's operands on the fixture's BCSR form, X of width ``d``."""
    b = BCSRMatrix.from_csr(FIXTURES[fixture](), bm, bk)
    cols, vals, kmax = k10._pad_to_kmax(b)
    x = np.zeros((b.shape[1], d), np.float32)
    a_n = FIXTURES[fixture]().n
    x[:a_n] = np.random.default_rng(d).standard_normal((a_n, d))
    return b, cols, vals, kmax, torch.from_numpy(x)


HEADER = CSRC / "spmm_gather_ring.cuh"


def header_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert found, f"{name} is not defined in {HEADER.name}"
    return int(found.group(1))


@pytest.mark.parametrize("d_pad", (20, 47, 100, 128, 200, 256, 640))
@pytest.mark.parametrize("bk", (1, 8, 32, 128))
@pytest.mark.parametrize("bm", (1, 8, 16))
def test_route(bm, bk, d_pad):
    fits = k10.ring_bytes(bm=bm, bk=bk) <= k10.MAX_SHARED_BYTES
    assert k10.ring_route(d_pad, bm=bm, bk=bk) == (d_pad % 128 == 0 and fits)
    # four 64 KB stages at bk = 128 do not fit a CTA
    assert fits == (bk < 128)


@pytest.mark.parametrize("bk", (1, 2, 3, 4, 8, 16, 32))
@pytest.mark.parametrize("bm", (1, 2, 4, 8, 16))
def test_ring_geometry_and_bytes(bm, bk):
    rows8 = header_constant("kStageRows")
    g = k10.ring_geometry(bm=bm, bk=bk)
    # whole block steps of one block-row, at least 8 X rows a stage where
    # bk allows (block_steps in the header), one column a producer lane
    assert g["steps"] == (rows8 // bk if bk < rows8 else 1)
    assert g["rows"] == g["steps"] * bk and g["panel"] == g["steps"] * bm * bk
    assert g["rows"] >= min(rows8, bk) and g["steps"] <= 32
    assert g["rows"] > rows8 - bk
    slots, stages = header_constant("kSlots"), header_constant("kXStages")
    want = 2 * (slots + stages) * 8 + stages * (g["rows"] * 128
                                                + -(-g["panel"] // 4) * 4) * 4
    assert k10.ring_bytes(bm=bm, bk=bk) == want
    assert want % 16 == 0 and want <= k10.MAX_SHARED_BYTES
    # at bk >= 8 a stage is K2's: one block step, bk rows and a panel
    if bk >= rows8:
        assert g["steps"] == 1 and want <= k2.ring_bytes(bm=bm, bk=bk)


def test_the_ring_source_computes_the_table():
    header = HEADER.read_text()
    assert "struct BlockRows" in header
    # block-row i: kmax steps from block-column i * kmax, value panels
    # from (i * kmax) * bm * bk
    assert "return bk < kStageRows ? kStageRows / bk : 1;" in header
    assert "p.vals + (static_cast<long long>(i) * kmax + s0) * step;" in header
    assert "__ldg(p.cols + static_cast<long long>(i) * kmax" in header
    # each step's panel stored transposed, read a panel column at a time
    assert "cp_async4(panel + s * per + c * BM + r, a + e);" in header
    assert "load_row<BM>(w, a + c * BM);" in header
    launcher = (CSRC / "spmm_bcsr.cu").read_text()
    assert "spmm_ring::launch<BM, true, spmm_ring::BlockRows>" in launcher
    assert "p.kc = kmax" in launcher and "if (threads == 0)" in launcher
    assert len(k10._ARGTYPES) == 11
    tag, off, coff, L = k10.bcsr_tables(5, 3, bm=8, bk=4, device="cpu")
    assert all(t.dtype == torch.int32 for t in (tag, off, coff, L))
    assert tag.tolist() == [1] * 5 and L.tolist() == [3] * 5
    assert off.tolist() == [i * 3 * 8 * 4 for i in range(5)]
    assert coff.tolist() == [i * 3 for i in range(5)]


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_table_walked_by_k2_plain_equals_k10_plain(fixture, bm, bk, d):
    b, cols, vals, kmax, x = operands(fixture, bm, bk, d)
    tables = k10.bcsr_tables(b.n_block_rows, kmax, bm=bm, bk=bk,
                             device="cpu")
    want = k10.spmm_bcsr_plain(cols, vals, x, kmax=kmax)
    got = spmm_bcsr_fused_plain(*tables, cols, vals.reshape(-1), x, bm=bm,
                                bk=bk)
    assert torch.equal(got, want)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(k10.spmm_bcsr(cols, vals, x, kmax=kmax), want)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_k10_matches_reference_kernel(fixture, bm, bk, d):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.spmm_bcsr import spmm_bcsr as ref_bcsr
    b, cols, vals, kmax, x = operands(fixture, bm, bk, d)
    want = np.asarray(ref_bcsr(jnp.asarray(cols.numpy()),
                               jnp.asarray(vals.numpy()),
                               jnp.asarray(x.numpy()), kmax=kmax,
                               interpret=True))
    got = k10.spmm_bcsr(cols, vals, x, kmax=kmax)
    assert got.shape == (b.shape[0], d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- on the card ------------------------------------------------------------

def _needs_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


@pytest.mark.cuda
def test_cuda_both_routes_equal_plain():
    _needs_hopper()
    routes = set()
    cases = [(f, bm, bk, d) for f, bm, bk, d in itertools.product(
        sorted(FIXTURES), (1, 2, 4, 8, 16), (1, 3, 8), WIDTHS + (256,))]
    # a ring over a CTA's shared memory takes the narrow body at 128
    cases += [("mixed", 8, 128, 128), ("banded", 1, 128, 256)]
    for fixture, bm, bk, d in cases:
        _, cols, vals, kmax, x = operands(fixture, bm, bk, d)
        cols, vals, x = cols.cuda(), vals.cuda(), x.cuda()
        launches = k10.spmm_bcsr.launches
        got = k10.spmm_bcsr(cols, vals, x, kmax=kmax)
        want = k10.spmm_bcsr_plain(cols, vals, x, kmax=kmax)
        torch.cuda.synchronize()
        assert k10.spmm_bcsr.launches == launches + 1
        assert torch.equal(got, want), (fixture, bm, bk, d)
        routes.add(k10.ring_route(d, bm=bm, bk=bk))
    assert routes == {True, False}
