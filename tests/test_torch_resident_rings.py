"""K5 on K6's warp-specialised CTA, and K1 beside K3, on the CPU and
(``cuda``-marked) on the card.

K5 (``csrc/attn_fused.cu``) runs ``csrc/attn_ring.cuh``'s CTA with its
resident descriptor source; its geometry (K6's K/V ring with the weight
panel in each stage, fewer stages where that does not fit a CTA, none
where not even one does) is mirrored by ``kernels/attn_fused.py::
resident_geometry`` / ``resident_ring_bytes``, and its wrapper zero-pads
a ragged head width (``head_padded``).  K1 (``csrc/spmm_ell_fused.cu``,
one thread a column) takes X of any width and alignment.  The CPU can
hold the mirrors to the sources, the acceptance of every instance the
first K5 (one warp a row) accepted, the arithmetic of the padding and
K1's columns at an unplanned width; the ``cuda`` tests hold the kernels
to their staged twins bit for bit and to their plain versions:

    PYTHONPATH=src python -m pytest -q -m cuda \
        tests/test_torch_resident_rings.py
"""
import importlib
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

attn_mod = importlib.import_module("repro_torch.kernels.attn_fused")
ell_mod = importlib.import_module("repro_torch.kernels.spmm_ell_fused")

CSRC = Path(attn_mod.__file__).parent / "csrc"
HEADER = CSRC / "attn_ring.cuh"
BMS = (1, 2, 4, 8, 16)
BKS = (1, 8, 32)
MAX_SMEM = 232448


def header_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert found, f"{name} is not defined in {HEADER.name}"
    return int(found.group(1))


def test_resident_mirror_constants_match_the_source():
    assert attn_mod.WIN_SLOTS == header_constant("kWinSlots")
    assert attn_mod.ITEM_BYTES == header_constant("kItemBytes")
    assert attn_mod.KV_ROWS == header_constant("kKVRows")
    assert attn_mod.KV_MAX_STAGES == header_constant("kMaxStages")
    assert attn_mod.VPU_PAIRS == header_constant("kVpuPairs")
    assert header_constant("kMaxSmem") == MAX_SMEM
    assert attn_mod.MAX_SHARED_BYTES == MAX_SMEM
    assert attn_mod.HEAD_ALIGN == 32 == attn_mod.COL_TILE // 4
    # K5's launcher sizes its CTA with the functions the mirror follows
    launcher = (CSRC / "attn_fused.cu").read_text()
    assert "resident_geometry(bm, bk, dh_pad)" in launcher
    assert "resident_bytes(g, bm)" in launcher
    assert "Resident<LEAN>" in launcher


def resident_model(g: dict, bm: int) -> int:
    """K5's shared memory from the header's constants: the barriers and
    item records, the stages, the Q block (none when LEAN), two halves
    of the weight and rescale buffers, the denominators."""
    slots = header_constant("kWinSlots")
    stages = header_constant("kMaxStages")
    barriers = (2 * (slots + stages) * 8
                + slots * header_constant("kItemBytes"))
    q = bm * g["qstride"] if g["stages"] else 0
    return barriers + 4 * (g["stages"] * g["stage"] + q + 4 * bm * g["pw"]
                           + -(-bm // 4) * 4)


@pytest.mark.parametrize("dh_pad", (32, 128, 512, 1024, 4096, 8192, 58112))
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
def test_resident_geometry(bm, bk, dh_pad):
    g = attn_mod.resident_geometry(bm=bm, bk=bk, dh_pad=dh_pad)
    k6 = attn_mod.kv_geometry(bm=bm, bk=bk, dh_pad=dh_pad)
    nbytes = attn_mod.resident_ring_bytes(bm=bm, bk=bk, dh_pad=dh_pad)
    assert nbytes == resident_model(g, bm) <= MAX_SMEM
    assert g["rows"] == bk and g["group"] == k6["group"]
    n = g["stages"]
    assert n == 0 or (n & (n - 1) == 0 and n <= k6["stages"])
    if n:
        # K6's ring, each stage also holding the (bm x bk) weight panel
        assert g["qstride"] == dh_pad + 4
        floor = bk * (dh_pad + 4 + 128) + -(-bm * bk // 4) * 4
        assert floor <= g["stage"] < floor + 32 and g["stage"] % 32 == 4
        assert g["mgroup"] <= max(n // 2, 1)
        if n < k6["stages"]:     # halved: twice the stages did not fit
            two_n = dict(g, stages=2 * n, **attn_mod._groups(
                bm=bm, bk=bk, stages=2 * n))
            assert resident_model(two_n, bm) > MAX_SMEM
    else:
        # LEAN: not even one stage fits; Q and K/V are read in place
        assert g["qstride"] == dh_pad and g["stage"] == 0
        stage = bk * (dh_pad + 4 + 128) + -(-bm * bk // 4) * 4
        one = dict(g, stages=1, stage=stage + (36 - stage % 32) % 32,
                   qstride=dh_pad + 4,
                   **attn_mod._groups(bm=bm, bk=bk, stages=1))
        assert resident_model(one, bm) > MAX_SMEM
    G = 1 << (bk - 1).bit_length()
    mg = g["mgroup"]
    assert mg & (mg - 1) == 0 and mg * G <= 32
    assert mg == 1 or bm * mg * G <= 128
    assert g["pw"] % 4 == 0 and g["pw"] >= max(g["group"], mg * bk, 2 * mg)


def test_resident_geometry_is_k6s_at_the_main_paths_widths():
    # (c) and the layer: dh = 128, bm = 8 at bk = 8, and bm = 16 / bk = 1
    for bm, bk in ((8, 8), (16, 8), (8, 1)):
        g = attn_mod.resident_geometry(bm=bm, bk=bk, dh_pad=128)
        k6 = attn_mod.kv_geometry(bm=bm, bk=bk, dh_pad=128)
        assert {key: g[key] for key in g if key != "stage"} == {
            key: k6[key] for key in k6 if key != "stage"}


def first_k5_accepts(bm: int, bk: int, dh_pad: int) -> bool:
    """The first K5's acceptance (its ``check_attn`` beyond the
    operands' shapes): a supported bm, bk within a warp, and its
    attention state — the Q block, two halves of the weights and the
    rescales, the denominators — within a CTA's shared memory."""
    return (bm in BMS and bk <= 32
            and 4 * (bm * dh_pad + 2 * bm * bk + 3 * bm) <= MAX_SMEM)


def first_k5_widest(bm: int, bk: int) -> int:
    return (MAX_SMEM // 4 - 2 * bm * bk - 3 * bm) // bm


def one_descriptor(bm: int, bk: int, dh_pad: int, tag: int):
    """A one-descriptor plan whose rows all read K/V row 0 (VPU) or
    block-column 0 (MXU), with its operands."""
    i32 = dict(dtype=torch.int32)
    tables = [torch.tensor([tag], **i32), torch.zeros(1, **i32),
              torch.zeros(1, **i32), torch.ones(1, **i32)]
    n = bk * bm if tag else bm
    cols = torch.zeros(n, **i32)
    vals = torch.full((n,), 0.5)
    g = torch.Generator().manual_seed(bm * 1000 + bk * 10 + tag)
    q = torch.randn(bm, dh_pad, generator=g)
    k = torch.randn(bk, dh_pad, generator=g)
    v = torch.randn(bk, 128, generator=g)
    return (*tables, cols, vals, q, k, v)


@pytest.mark.parametrize("dh", (47, 64, 100, 128, 512, "widest"))
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
def test_k5_accepts_every_instance_the_first_k5_accepted(bm, bk, dh):
    dh_pad = first_k5_widest(bm, bk) if dh == "widest" else dh
    assert first_k5_accepts(bm, bk, dh_pad)
    if dh == "widest":
        assert not first_k5_accepts(bm, bk, dh_pad + 1)
    for tag in (0, 1):
        ops = one_descriptor(bm, bk, dh_pad, tag)
        tables = dict(zip(("blk_tag", "blk_off", "blk_coff", "blk_L"),
                          ops[:4]))
        attn_mod.check_attn(tables, *ops[4:], bm=bm, bk=bk, mw=1)
        # the wrapper itself takes it (on the CPU: the plain version)
        y = attn_mod.attn_fused(*ops, bm=bm, bk=bk)
        assert y.shape == (bm, 128) and bool(torch.isfinite(y).all())
    width = attn_mod.head_width(dh_pad)
    g = attn_mod.resident_geometry(bm=bm, bk=bk, dh_pad=width)
    assert attn_mod.resident_ring_bytes(bm=bm, bk=bk, dh_pad=width) <= MAX_SMEM
    # every head width the first K5 took that K6's ring takes as it is
    # runs K6's geometry; the widest run with fewer stages or none
    if dh in (64, 128):
        assert g["stages"] >= 1


# -- the head padding, in float32 ---------------------------------------------

def f32(x):
    return np.float32(x)


def lane_partials(q, k):
    """Lane l's fmaf chain over j = l, l + 32, ... from 0 (fma in
    float64, rounded once: exact for float32 operands)."""
    out = []
    for lane in range(32):
        acc = f32(0)
        for j in range(lane, q.size, 32):
            acc = f32(np.float64(q[j]) * np.float64(k[j]) + np.float64(acc))
        out.append(acc)
    return out


def butterfly(parts):
    v = [f32(p) for p in parts]
    s = 16
    while s:
        v = [f32(v[l] + v[l ^ s]) for l in range(32)]
        s //= 2
    return v[0]


@pytest.mark.parametrize("dh", (1, 6, 47, 100, 130))
def test_head_padding_leaves_every_lane_partial_and_score(dh):
    rng = np.random.default_rng(dh)
    q = (rng.standard_normal(dh) * 3).astype(np.float32)
    k = rng.standard_normal(dh).astype(np.float32)
    q[0] = np.float32(-0.0)              # a signed zero among the terms
    width = attn_mod.head_width(dh)
    assert width % 32 == 0 and 0 <= width - dh < 32
    qp, kp = attn_mod.head_padded(torch.from_numpy(q)[None],
                                  torch.from_numpy(k)[None])
    assert qp.shape == kp.shape == (1, width)
    assert torch.equal(qp[0, :dh], torch.from_numpy(q))
    assert not bool(qp[0, dh:].any()) and not bool(kp[0, dh:].any())
    padded = lane_partials(qp[0].numpy(), kp[0].numpy())
    assert padded == lane_partials(q, k)          # value by value
    assert butterfly(padded) == butterfly(lane_partials(q, k))


def test_head_padded_keeps_a_whole_width():
    q, k = torch.ones(3, 64), torch.ones(5, 64)
    qp, kp = attn_mod.head_padded(q, k)
    assert qp is q and kp is k


@pytest.mark.parametrize("dh", (47, 100))
def test_k5_plain_result_is_the_padded_operands_result(dh):
    """On the CPU the wrapper runs the plain version on the operands as
    given; the padded operands the card's launch takes give the same
    rows to rounding (the plain score sums in torch's order)."""
    ops = list(one_descriptor(8, 8, dh, 1))
    want = attn_mod.attn_fused(*ops, bm=8, bk=8)
    ops[6], ops[7] = attn_mod.head_padded(ops[6], ops[7])
    got = attn_mod.attn_fused(*ops, bm=8, bk=8)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# -- K1: any width ---------------------------------------------------------

@pytest.mark.parametrize("d", (1, 47, 100, 128, 129, 256))
def test_k1_columns_do_not_depend_on_the_width_around_them(d):
    """K1 takes X at any width: each output column is its own
    gather-sum, so the caller's columns of the planned (padded) width's
    result are the unplanned width's."""
    from repro_torch.core import JitCache, compile_spmm, random_csr
    a = random_csr(60, 50, density=0.1, family="powerlaw", seed=d,
                   device="cpu")
    c = compile_spmm(a, d, backend="pallas_ell", staging="resident",
                     device="cpu", cache=JitCache())
    x = torch.randn(a.n, d, generator=torch.Generator().manual_seed(d))
    (off, L, cols, vals, x_plan), knobs = c.fused_operands(a.vals, x)
    assert x_plan.shape[1] % 128 == 0 and x_plan.shape[1] >= d
    cut = x_plan[:, :d].contiguous()
    want = ell_mod.spmm_ell_fused(off, L, cols, vals, x_plan, **knobs)
    got = ell_mod.spmm_ell_fused(off, L, cols, vals, cut, **knobs)
    assert got.shape == (want.shape[0], d)
    assert torch.equal(got, want[:, :d])


# -- on the card ---------------------------------------------------------------

def _card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


def _misaligned(t):
    view = torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


def _masks():
    """The weighted powerlaw mask and a hub row over 600 columns with a
    dense 8-row block-row (MXU blocks, windows over a 64-entry slot)."""
    from repro_torch.core import CSRMatrix, random_csr
    s = random_csr(48, 40, density=0.15, family="powerlaw", seed=3,
                   device="cpu")
    w = np.random.default_rng(4).uniform(0.2, 2.0, s.nnz)
    weighted = CSRMatrix(s.shape, s.row_ptr, s.col_indices,
                         torch.tensor(w, dtype=torch.float32, device="cuda"))
    rng = np.random.default_rng(0)
    hub = np.zeros((40, 600), np.float32)
    hub[3] = rng.uniform(0.2, 2.0, 600)
    hub[8:16, :64] = rng.uniform(0.2, 2.0, (8, 64))
    for i in range(40):
        hub[i, rng.choice(600, 3, replace=False)] = rng.uniform(0.2, 2.0, 3)
    return {"weighted": weighted,
            "hub": CSRMatrix.from_dense(hub, device="cuda")}


@pytest.mark.cuda
def test_cuda_k5_equals_k6_and_its_plain_version():
    _card()
    from repro_torch.core import JitCache, compile_sparse_attention
    from repro_torch.kernels import (attn_fused, attn_fused_plain,
                                     attn_fused_staged)
    gen = torch.Generator(device="cuda").manual_seed(0)
    merged = False
    for (name, a), (backend, bk), mt, bm in itertools.product(
            _masks().items(), (("pallas_ell", 8), ("pallas_bcsr", 1),
                               ("pallas_bcsr", 8), ("pallas_bcsr", 32)),
            (0, 16), BMS):
        c = compile_sparse_attention(a, 100, 128, backend=backend, bm=bm,
                                     bk=bk, merge_threshold=mt,
                                     staging="resident", cache=JitCache())
        merged |= c.workspace.merge_width > 1
        q = torch.randn(a.m, 100, device="cuda", generator=gen) / 10
        k = torch.randn(a.n, 100, device="cuda", generator=gen)
        v = torch.randn(a.n, 128, device="cuda", generator=gen)
        ops, kw = c.fused_operands(a.vals, q, k, v)
        win = dict(span=c.workspace.max_span, cspan=c.workspace.max_cspan)
        before = attn_fused.launches
        got = attn_fused(*ops, **kw)
        assert attn_fused.launches == before + 1
        want = attn_fused_plain(*ops, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for cap in (None, 64):
            assert torch.equal(attn_fused_staged(*ops, **kw, **win, cap=cap),
                               got), (name, backend, bk, mt, bm, cap)
        # the ragged head width 100 called directly, and a misaligned K
        cut = list(ops)
        cut[6] = ops[6][:, :100].contiguous()
        cut[7] = ops[7][:, :100].contiguous()
        assert torch.equal(attn_fused(*cut, **kw), got)
        cut = list(ops)
        cut[7] = _misaligned(ops[7])
        assert torch.equal(attn_fused(*cut, **kw), got)
    assert merged


@pytest.mark.cuda
def test_cuda_k1_equals_k3_and_its_plain_version():
    _card()
    from repro_torch.core import JitCache, compile_spmm
    from repro_torch.kernels import (spmm_ell_fused, spmm_ell_fused_plain,
                                     spmm_ell_fused_staged)
    gen = torch.Generator(device="cuda").manual_seed(1)
    merged = False
    for (name, a), mt, bm, d in itertools.product(
            _masks().items(), (0, 16), BMS, (47, 128, 300)):
        c = compile_spmm(a, d, backend="pallas_ell", staging="resident",
                         bm=bm, merge_threshold=mt, cache=JitCache())
        merged |= c.workspace.merge_width > 1
        x = torch.randn(a.n, d, device="cuda", generator=gen)
        ops, kw = c.fused_operands(a.vals, x)
        win = dict(span=c.workspace.max_span, cspan=c.workspace.max_cspan)
        before = spmm_ell_fused.launches
        got = spmm_ell_fused(*ops, **kw)
        assert spmm_ell_fused.launches == before + 1
        want = spmm_ell_fused_plain(*ops, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for cap in (None, 64):
            assert torch.equal(spmm_ell_fused_staged(*ops, **kw, **win,
                                                     cap=cap), got)
        # the unplanned width called directly, and a misaligned X
        cut = list(ops)
        cut[4] = ops[4][:, :d].contiguous()
        assert torch.equal(spmm_ell_fused(*cut, **kw), got[:, :d])
        cut[4] = _misaligned(ops[4])
        assert torch.equal(spmm_ell_fused(*cut, **kw), got)
    assert merged
