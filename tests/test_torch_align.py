"""``aligned16``: a valid float32 view that starts off a 16-byte boundary
is computed, not refused.

The staged and ring kernels copy their operands in 16-byte units and
refuse a misaligned pointer at launch.  The entry points therefore pass
the dense operands they hand such kernels (X of an SpMM forward, K and V
of an attention forward, a chip's rows of a sharded operand, and dY and
X of the SDDMM) through ``aligned16``, which copies only a misaligned
CUDA tensor.  On the CPU these tests show each entry point routing its
operands through the helper; the ``cuda``-marked tests show on a Hopper
card that a misaligned X, K or V gives the default (staged) forward
exactly what ``staging="resident"`` gives, and that K7 and K9 give a
misaligned operand's result bit for bit the aligned one's:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_align.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import (chip_mesh, compile_sparse_attention,
                              compile_spmm, random_csr)
from repro_torch.core.jit_cache import JitCache
from repro_torch.distributed import aligned16, place_on_chips
from repro_torch.kernels import sddmm_csr, spmm_ell_segment

spmm_mod = importlib.import_module("repro_torch.core.spmm")
sddmm_mod = importlib.import_module("repro_torch.kernels.sddmm")
sharding_mod = importlib.import_module("repro_torch.distributed.sharding")


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary: ``torch.empty(numel + 1)[1:].view(shape)``."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


def test_aligned16_returns_an_aligned_cpu_view_itself():
    base = torch.arange(64 * 128, dtype=torch.float32).view(64, 128)
    for view in (base, base[8:], base[:, :64]):
        assert view.data_ptr() % 16 == 0
        assert aligned16(view) is view


def test_aligned16_leaves_a_misaligned_cpu_view_alone():
    # the CPU runs the plain versions, which take any view
    view = torch.empty(64 * 128 + 1)[1:].view(64, 128)
    assert view.data_ptr() % 16 and aligned16(view) is view


class Recorder:
    """Wraps ``aligned16``, recording the shape of every tensor it is
    given."""

    def __init__(self):
        self.shapes = []

    def __call__(self, t):
        self.shapes.append(tuple(t.shape))
        return aligned16(t)


def mixed(seed=0, m=48, n=64):
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(16):
        dense[i, (i // 8) * 16:(i // 8) * 16 + 16] = rng.standard_normal(16)
    for i in range(16, m):
        dense[i, rng.choice(n, size=2, replace=False)] = rng.standard_normal(2)
    from repro_torch.core import CSRMatrix
    return CSRMatrix.from_dense(dense, device="cpu")


def spmm_forward(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(spmm_mod, "aligned16", rec)
    a = mixed()
    c = compile_spmm(a, 20, backend="pallas_bcsr", device="cpu",
                     cache=JitCache())
    c(a.vals, torch.randn(a.n, 20))
    # X padded to the lane tile and to whole block-columns of rows
    return rec.shapes, [(c._x_rows_pad, c.d_tiling.d_pad)]


def attention_forward(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(spmm_mod, "aligned16", rec)
    from repro_torch.models.sparse_attention import sparse_attention_mask
    a = sparse_attention_mask(64, 16, 4, device="cpu")
    c = compile_sparse_attention(a, 16, 24, backend="pallas_ell",
                                 device="cpu", cache=JitCache())
    q, k, v = torch.randn(64, 16), torch.randn(64, 16), torch.randn(64, 24)
    c(a.vals, q, k, v)
    rows = c._kv_rows_pad
    return rec.shapes, [(rows, c._dh_pad), (rows, c.d_tiling.d_pad)]


def backward_dvals(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(spmm_mod, "aligned16", rec)
    a = mixed(seed=1)
    c = compile_spmm(a, 24, backend="pallas_ell", device="cpu",
                     cache=JitCache())
    vals = a.vals.clone().requires_grad_(True)
    x = torch.randn(a.n, 24)
    c(vals, x).sum().backward()
    # the forward's X, then dY and X of the SDDMM, as given
    return rec.shapes, [(c._x_rows_pad, c.d_tiling.d_pad), (a.m, 24),
                        (a.n, 24)]


def sddmm_entry(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(sddmm_mod, "aligned16", rec)
    a = mixed(seed=2)
    sddmm_csr(a, torch.randn(a.m, 40), torch.randn(a.n, 40), device="cpu")
    return rec.shapes, [(a.m, 128), (a.n, 128)]


def chip_rows(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(sharding_mod, "aligned16", rec)
    place_on_chips(torch.randn(3, 5, 8), chip_mesh(3, device="cpu"))
    return rec.shapes, [(5, 8)] * 3


SITES = {"spmm_forward": spmm_forward,
         "attention_forward": attention_forward,
         "backward_dvals": backward_dvals, "sddmm_csr": sddmm_entry,
         "place_on_chips": chip_rows}


@pytest.mark.parametrize("site", sorted(SITES))
def test_entry_points_pass_their_kernel_operands_through_aligned16(
        site, monkeypatch):
    seen, want = SITES[site](monkeypatch)
    assert seen == want


# -- on the card ------------------------------------------------------------

def _needs_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


@pytest.mark.cuda
def test_cuda_aligned16_copies_only_a_misaligned_tensor():
    _needs_hopper()
    t = torch.randn(64, 128, device="cuda")
    assert aligned16(t) is t
    view = misaligned(t)
    out = aligned16(view)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    assert out.data_ptr() != view.data_ptr() and torch.equal(out, t)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ("pallas_ell", "pallas_bcsr"))
def test_cuda_default_spmm_forward_takes_a_misaligned_x(backend):
    _needs_hopper()
    a = random_csr(300, 256, density=0.05, family="powerlaw", seed=5)
    x = torch.randn(a.n, 128, device="cuda")
    dma = compile_spmm(a, 128, backend=backend, cache=JitCache())
    res = compile_spmm(a, 128, backend=backend, staging="resident",
                       cache=JitCache())
    assert dma.staging == "dma"
    got = dma(a.vals, misaligned(x))
    assert torch.equal(got, res(a.vals, misaligned(x)))
    assert torch.equal(got, dma(a.vals, x))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ("pallas_ell", "pallas_bcsr"))
def test_cuda_default_attention_takes_misaligned_k_and_v(backend):
    _needs_hopper()
    from repro_torch.models.sparse_attention import sparse_attention_mask
    a = sparse_attention_mask(1024, 128, 16)
    q, k, v = (torch.randn(1024, 128, device="cuda") for _ in range(3))
    dma = compile_sparse_attention(a, 128, 128, backend=backend,
                                   cache=JitCache())
    res = compile_sparse_attention(a, 128, 128, backend=backend,
                                   staging="resident", cache=JitCache())
    assert dma.staging == "dma"
    got = dma(a.vals, q, misaligned(k), misaligned(v))
    assert torch.equal(got, res(a.vals, q, misaligned(k), misaligned(v)))
    assert torch.equal(got, dma(a.vals, q, k, v))


@pytest.mark.cuda
def test_cuda_sddmm_and_segment_take_misaligned_operands():
    _needs_hopper()
    from repro_torch.core.plan import build_plan
    from repro_torch.kernels import sddmm
    a = random_csr(300, 256, density=0.05, family="powerlaw", seed=6)
    for d in (47, 128):
        dy = torch.randn(a.m, d, device="cuda")
        x = torch.randn(a.n, d, device="cuda")
        assert torch.equal(sddmm_csr(a, misaligned(dy), misaligned(x)),
                           sddmm_csr(a, dy, x))
        rows, cols, _, _ = sddmm_mod._csr_pairs(a, dy, x, device="cuda:0")
        assert torch.equal(sddmm(rows, cols, misaligned(dy), misaligned(x)),
                           sddmm(rows, cols, dy, x))
    plan = build_plan(a.row_ptr, a.col_indices, a.shape, 128)
    x = torch.randn(a.n, 128, device="cuda")
    vals_ext = torch.cat([a.vals, a.vals.new_zeros(1)])
    for seg in plan.segments:
        cols = torch.from_numpy(seg.cols_pad.reshape(-1)).cuda()
        vals = vals_ext[torch.from_numpy(seg.gather_idx).cuda()]
        assert torch.equal(spmm_ell_segment(cols, vals, misaligned(x)),
                           spmm_ell_segment(cols, vals, x))
