"""K6's shared-memory layout (``csrc/attn_ring.cuh``, the CTA that
``csrc/attn_fused_staged.cu`` launches) and its
Python mirrors ``kernels/attn_fused.py::kv_geometry`` / ``ring_bytes``,
and the arithmetic its scores rest on, on the CPU.

The kernel runs only on the card; what the CPU can hold is that the
mirror counts what the source declares, that every row-block size and
block width fits a CTA at the default slot, a 64-entry one and the
longformer mask's 4736-entry window (walked in chunks), that the checks
refuse what does not fit, and that the re-association the kernel uses
(a warp's butterfly sum split over 1, 2 or 4 threads; a block's sum over
its live lanes; a running max scanned over steps) gives K5's results
bit for bit, modelled here in float32.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

attn_mod = importlib.import_module("repro_torch.kernels.attn_fused")
stage_mod = importlib.import_module("repro_torch.kernels.spmm_ell_fused")

SOURCE = Path(attn_mod.__file__).parent / "csrc" / "attn_ring.cuh"
BMS = (1, 2, 4, 8, 16)
BKS = (1, 8)
MASK_C_SPAN = 4736          # the longformer mask's widest window


def source_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert found, f"{name} is not defined in {SOURCE.name}"
    return int(found.group(1))


def test_mirror_constants_match_the_source():
    assert attn_mod.WIN_SLOTS == source_constant("kWinSlots")
    assert attn_mod.ITEM_BYTES == source_constant("kItemBytes")
    assert attn_mod.KV_ROWS == source_constant("kKVRows")
    assert attn_mod.KV_MAX_STAGES == source_constant("kMaxStages")
    assert attn_mod.VPU_PAIRS == source_constant("kVpuPairs")
    assert source_constant("kMaxT") == 4


def pow2_floor(v: int) -> int:
    p = 1
    while 2 * p <= v:
        p *= 2
    return p


@pytest.mark.parametrize("dh_pad", (32, 128, 256))
@pytest.mark.parametrize("bk", BKS + (16, 32))
@pytest.mark.parametrize("bm", BMS)
def test_kv_geometry(bm, bk, dh_pad):
    g = attn_mod.kv_geometry(bm=bm, bk=bk, dh_pad=dh_pad)
    rows = bk                        # an MXU step's panel rows
    assert g["rows"] == rows and g["qstride"] == dh_pad + 4
    # K rows then V-tile rows, padded so a stage starts 4 banks on
    assert g["stage"] >= rows * (dh_pad + 4 + 128)
    assert g["stage"] - rows * (dh_pad + 4 + 128) < 32
    assert g["stage"] % 32 == 4 and g["qstride"] % 32 == 4
    n = g["stages"]
    assert n == min(max(pow2_floor(max(32 // rows, 1)), 2), 16)
    assert n & (n - 1) == 0          # indexed with masks and shifts
    # a VPU group: VPU_PAIRS (row, step) pairs, at most 32 steps
    s = g["group"]
    assert s == pow2_floor(min(max(source_constant("kVpuPairs") // bm, 1),
                               32))
    assert s & (s - 1) == 0 and s * bm <= 128
    # an MXU group: one pair a thread, a row's lanes within a warp, the
    # producer a group ahead
    G = 1 << (bk - 1).bit_length()
    mg = g["mgroup"]
    assert mg & (mg - 1) == 0 and mg <= max(n // 2, 1)
    assert mg * G <= 32 and (mg == 1 or bm * mg * G <= 128)
    assert g["pw"] % 4 == 0 and g["pw"] >= max(s, mg * bk, 2 * mg)


def ring_model(c: int, bm: int, bk: int, dh_pad: int) -> int:
    g = attn_mod.kv_geometry(bm=bm, bk=bk, dh_pad=dh_pad)
    slots, stages = source_constant("kWinSlots"), source_constant("kMaxStages")
    barriers = 2 * (slots + stages) * 8 + slots * source_constant("kItemBytes")
    windows = 2 * slots * (c + 4) * 4
    kv = g["stages"] * g["stage"] * 4
    q = bm * g["qstride"] * 4
    weights = 2 * 2 * bm * g["pw"] * 4       # weights and rescales, 2 halves
    denominators = -(-bm // 4) * 4 * 4
    return barriers + windows + kv + q + weights + denominators


def slot_caps():
    # the default slot of a small workspace, a 64-entry one, and mask
    # (c)'s window, which the default 1024-entry cap walks in chunks
    return (("small", 256, None), ("slot64", 256, 64),
            ("mask_c", MASK_C_SPAN, None))


@pytest.mark.parametrize("case", slot_caps(), ids=lambda c: c[0])
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
def test_ring_bytes_and_fit(bm, bk, case):
    _, span, cap = case
    c, ch, kc = stage_mod.staging_geometry(span, span, bm=bm, bk=bk, cap=cap)
    if span == MASK_C_SPAN:
        assert c == stage_mod.STAGE_CAP < span    # chunked
    nbytes = attn_mod.ring_bytes(c, bm=bm, bk=bk, dh_pad=128)
    assert nbytes == ring_model(c, bm, bk, 128)
    assert nbytes <= stage_mod.MAX_SHARED_BYTES == 232448
    # 16-byte copy destinations: barriers, slots and stages
    assert (2 * (attn_mod.WIN_SLOTS + attn_mod.KV_MAX_STAGES) * 8
            + attn_mod.WIN_SLOTS * attn_mod.ITEM_BYTES) % 16 == 0
    assert ((c + 4) * 4) % 16 == 0
    attn_mod.check_staged_attn(torch.zeros(8, 128), c=c, bm=bm, bk=bk)


def test_checks_refuse_a_ring_over_the_cta_and_a_ragged_head():
    q = torch.zeros(16, 2048)
    assert attn_mod.ring_bytes(1024, bm=16, bk=8, dh_pad=2048) > 232448
    with pytest.raises(ValueError, match="exceeds"):
        attn_mod.check_staged_attn(q, c=1024, bm=16, bk=8)
    with pytest.raises(ValueError, match="multiple of 32"):
        attn_mod.check_staged_attn(torch.zeros(8, 48), c=64, bm=8, bk=8)


def test_staged_wrapper_refuses_before_running_the_plain_version():
    blk = torch.zeros(1, dtype=torch.int32)
    L = torch.ones(1, dtype=torch.int32)
    cols = torch.zeros(16, dtype=torch.int32)
    vals = torch.ones(16)
    q = torch.zeros(8, 2048)
    k = torch.zeros(8, 2048)
    v = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="exceeds"):
        attn_mod.attn_fused_staged(blk, blk, blk, L, cols, vals, q, k, v,
                                   span=8, cspan=8, bm=8, bk=8)


# -- the arithmetic, in float32 ---------------------------------------------

def f32(x):
    return np.float32(x)


def butterfly(parts):
    """K5's warp_sum: every stage adds lane l ^ s to lane l; lane 0."""
    v = [f32(p) for p in parts]
    s = 16
    while s:
        v = [f32(v[l] + v[l ^ s]) for l in range(32)]
        s //= 2
    assert len({float(x) for x in v}) == 1      # every lane agrees
    return v[0]


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


def split_score(q, k, T):
    """The kernel's score<T>: thread t keeps lanes [t*W, t*W + W), the
    butterfly's stages 16..W pair threads, the rest run in place."""
    W = 32 // T
    parts = lane_partials(q, k)
    v = [parts[t * W:(t + 1) * W] for t in range(T)]
    h = 16
    while h >= W:
        v = [[f32(v[t][i] + v[t ^ (h // W)][i]) for i in range(W)]
             for t in range(T)]
        h //= 2
    results = []
    for t in range(T):
        x = list(v[t])
        h = W // 2
        while h:
            for i in range(h):
                x[i] = f32(x[i] + x[i + h])
            h //= 2
        results.append(x[0])
    assert len({float(r) for r in results}) == 1
    return results[0]


@pytest.mark.parametrize("dh_pad", (32, 128, 256))
@pytest.mark.parametrize("T", (1, 2, 4))
def test_split_score_equals_the_warp_butterfly(T, dh_pad):
    rng = np.random.default_rng(T * 1000 + dh_pad)
    for _ in range(4):
        q = (rng.standard_normal(dh_pad) * 3).astype(np.float32)
        k = rng.standard_normal(dh_pad).astype(np.float32)
        want = butterfly(lane_partials(q, k))
        assert split_score(q, k, T).tobytes() == want.tobytes()


@pytest.mark.parametrize("bk", (1, 3, 8, 12, 16, 17, 32))
def test_block_sum_over_live_lanes_equals_the_warp_sum(bk):
    """An MXU step's warp_sum(p) with zeros past bk is the butterfly of
    the G = next_pow2(bk) live-group lanes on p + 0."""
    rng = np.random.default_rng(bk)
    G = 1 << (bk - 1).bit_length()
    for _ in range(8):
        p = np.zeros(32, np.float32)
        p[:bk] = rng.uniform(0, 3, bk).astype(np.float32)
        if bk > 1:
            p[0] = np.float32(-0.0)
        want = butterfly(p)
        v = [f32(x + f32(0)) if G < 32 else f32(x) for x in p[:G]]
        d = G // 2
        while d:
            v = [f32(v[c] + v[c ^ d]) for c in range(G)]
            d //= 2
        assert v[0].tobytes() == want.tobytes()


def test_running_max_scan_equals_the_step_by_step_max():
    rng = np.random.default_rng(0)
    for S in (1, 2, 4, 8, 16):
        zm = rng.standard_normal(S).astype(np.float32)
        zm[rng.random(S) < 0.3] = np.float32(-1e30)
        m_in = np.float32(rng.standard_normal())
        seq, m = [], m_in
        for z in zm:
            m = np.fmax(m, z)
            seq.append(m)
        # the kernel: an inclusive scan by doubling, then fmax with m_in
        x = zm.copy()
        d = 1
        while d < S:
            x = np.array([np.fmax(x[s], x[s - d]) if s >= d else x[s]
                          for s in range(S)], np.float32)
            d *= 2
        assert np.array_equal(np.fmax(m_in, x), np.array(seq, np.float32))
