"""K7: the port's SDDMM against the reference's.

On the CPU ``sddmm_csr(..., device="cpu")`` runs the plain version,
held to the reference's Pallas ``sddmm_csr(..., interpret=True)`` and
to both packages' ``sddmm_ref`` oracles at rtol = atol = 1e-5: the same
products, each d-tile summed and then added in tile order, but a tile's
sum may run in another order.  The ``cuda``-marked test holds the CUDA
kernel to the plain version on a Hopper card.  A CUDA machine need not
have JAX, so the reference is imported inside the tests that use it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sddmm.py
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import CSRMatrix, random_csr
from repro_torch.kernels import ops, ref, sddmm, sddmm_csr, sddmm_plain

TOL = dict(rtol=1e-5, atol=1e-5)
port_sddmm = importlib.import_module("repro_torch.kernels.sddmm")


def powerlaw(m, n, seed, density=0.15):
    return random_csr(m, n, density=density, family="powerlaw", seed=seed,
                      device="cpu")


# name -> (m, n, d); the shapes of tests/test_kernels.py's
# test_sddmm_pallas_matches_ref plus a d that pads to two 512-wide tiles
SHAPES = {"12x18x9": (12, 18, 9), "40x33x45": (40, 33, 45),
          "8x8x128": (8, 8, 128), "40x33x640": (40, 33, 640)}


def structures():
    out = {name: powerlaw(m, n, seed=m + d)
           for name, (m, n, d) in SHAPES.items()}
    out["empty_rows"] = powerlaw(60, 40, seed=1, density=0.05)
    out["empty_matrix"] = CSRMatrix.from_dense(np.zeros((8, 8), np.float32),
                                               device="cpu")
    return out


WIDTHS = {**{name: d for name, (_, _, d) in SHAPES.items()},
          "empty_rows": 20, "empty_matrix": 16}


def operands(a, d, seed=0):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((a.m, d)).astype(np.float32)
    x = rng.standard_normal((a.n, d)).astype(np.float32)
    return dy, x


def reference_sddmm(a, dy, x, T):
    jnp = pytest.importorskip("jax.numpy")
    ref_sddmm = importlib.import_module("repro.kernels.sddmm")
    from repro.core import CSRMatrix as RefCSR
    ra = RefCSR(a.shape, a.row_ptr, a.col_indices,
                jnp.asarray(a.vals.numpy()))
    return np.asarray(ref_sddmm.sddmm_csr(
        ra, jnp.asarray(dy), jnp.asarray(x), T=T, interpret=True))


def test_fixtures_reach_empty_rows_and_ragged_pair_counts():
    s = structures()
    assert np.any(s["empty_rows"].row_lengths == 0)
    assert s["empty_matrix"].nnz == 0
    assert any(a.nnz % 8 for a in s.values())
    assert any(a.nnz % 128 for a in s.values())


@pytest.mark.parametrize("T", (8, 128))
@pytest.mark.parametrize("fixture", sorted(WIDTHS))
def test_plain_matches_reference_kernel_and_oracles(fixture, T):
    a = structures()[fixture]
    dy, x = operands(a, WIDTHS[fixture])
    want = reference_sddmm(a, dy, x, T)
    from repro.kernels import ref as ref_oracles
    jnp = pytest.importorskip("jax.numpy")
    want_ref = np.asarray(ref_oracles.sddmm_ref(
        a.row_ptr, a.col_indices, jnp.asarray(dy), jnp.asarray(x)))
    got = sddmm_csr(a, torch.from_numpy(dy), torch.from_numpy(x), T=T,
                    device="cpu")
    got_ref = ref.sddmm_ref(a.row_ptr, a.col_indices, torch.from_numpy(dy),
                            torch.from_numpy(x))
    assert got.shape == (a.nnz,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, **TOL)


@pytest.mark.parametrize("d_pad", (45, 100, 1024))
def test_direct_kernel_call_takes_unplanned_widths(d_pad):
    # the reference's sddmm takes any d_pad; its tiles halve 512 until
    # one divides d_pad (45 -> 45, 100 -> 100, 1024 -> two of 512)
    a = powerlaw(40, 33, seed=3)
    dy_t, x_t = (torch.from_numpy(t) for t in operands(a, d_pad, seed=2))
    rows, cols, _, _ = port_sddmm._csr_pairs(a, dy_t, x_t, T=8,
                                             device="cpu")
    got = sddmm(rows, cols, dy_t, x_t, T=8)
    want = sddmm_plain(rows, cols, dy_t, x_t, T=8)
    assert torch.equal(got, want)
    jnp = pytest.importorskip("jax.numpy")
    ref_sddmm = importlib.import_module("repro.kernels.sddmm")
    want_ref = np.asarray(ref_sddmm.sddmm(
        jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
        jnp.asarray(dy_t.numpy()), jnp.asarray(x_t.numpy()), T=8,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)


def test_padding_pairs_point_at_row_and_column_zero():
    a = powerlaw(12, 18, seed=21)
    dy, x = operands(a, 9)
    rows, cols, dy_t, x_t = port_sddmm._csr_pairs(
        a, torch.from_numpy(dy), torch.from_numpy(x), T=128, device="cpu")
    assert rows.shape == (128,) and rows.dtype == torch.int32
    assert not rows[a.nnz:].any() and not cols[a.nnz:].any()
    assert dy_t.shape == (12, 128) and not dy_t[:, 9:].any()


def test_dispatch_counts_one_per_call():
    a = powerlaw(40, 33, seed=3)
    dy, x = (torch.from_numpy(t) for t in operands(a, 12))
    empty = structures()["empty_matrix"]
    launches = sddmm.launches
    ops.reset_dispatch_counts()
    sddmm_csr(a, dy, x, device="cpu")
    assert ops.DISPATCH_COUNTS["sddmm"] == 1
    out = sddmm_csr(empty, torch.zeros(8, 4), torch.zeros(8, 4),
                    device="cpu")
    assert out.shape == (0,)
    assert dict(ops.DISPATCH_COUNTS) == {"sddmm": 2}
    # a launch count moves only when a CUDA kernel is launched
    assert sddmm.launches == launches


@pytest.mark.parametrize("device", (None, "cuda"))
def test_entry_point_raises_without_a_card(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = powerlaw(12, 18, seed=21)
    dy, x = (torch.from_numpy(t) for t in operands(a, 9))
    with pytest.raises(RuntimeError, match="CUDA"):
        sddmm_csr(a, dy, x, device=device)


@pytest.mark.parametrize("bad", ("dtype", "ragged", "width", "device",
                                 "rows", "contiguity"))
def test_rejects_malformed_operands(bad):
    a = powerlaw(12, 18, seed=21)
    dy, x = (torch.from_numpy(t) for t in operands(a, 9))
    if bad in ("width", "device", "rows"):
        if bad == "width":
            x = x[:, :5]
        elif bad == "rows":
            dy = dy[:-1]
        else:
            dy = dy.to("meta")
        with pytest.raises(ValueError):
            sddmm_csr(a, dy, x, device="cpu")
        return
    rows, cols, dy_t, x_t = port_sddmm._csr_pairs(a, dy, x, T=8,
                                                  device="cpu")
    if bad == "dtype":
        rows = rows.long()
    elif bad == "ragged":
        rows, cols = rows[:-1], cols[:-1]
    else:
        x_t = x_t.t().contiguous().t()
    with pytest.raises(ValueError):
        sddmm(rows, cols, dy_t, x_t, T=8)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")
    for (name, a), T in itertools.product(structures().items(), (8, 128)):
        dy, x = (torch.from_numpy(t).cuda()
                 for t in operands(a, WIDTHS[name]))
        launches = sddmm.launches
        got = sddmm_csr(a, dy, x, T=T)
        rows, cols, dy_t, x_t = port_sddmm._csr_pairs(a, dy, x, T=T,
                                                      device="cuda:0")
        want = sddmm_plain(rows, cols, dy_t, x_t, T=T)[:a.nnz]
        torch.cuda.synchronize()
        assert sddmm.launches == launches + (a.nnz > 0)
        torch.testing.assert_close(got, want, **TOL)
