"""The shared-memory layout of K3/K4's gather ring
(``csrc/spmm_gather_ring.cuh``) and its Python mirror
``kernels/spmm_ell_fused.py::ring_bytes``, on the CPU.

The CUDA kernels run only on the card; what the CPU can hold is that the
mirror counts the same barriers, slots and X stages as the header, that
every row-block size fits a CTA at the default slot and at a 64-entry
one, and that ``check_staged`` refuses a ring that does not fit.
"""
import importlib
import re
from pathlib import Path

import pytest
import torch

k3_mod = importlib.import_module("repro_torch.kernels.spmm_ell_fused")

HEADER = (Path(k3_mod.__file__).parent / "csrc" / "spmm_gather_ring.cuh")
BMS = (1, 2, 4, 8, 16)
BKS = (1, 8)


def header_constant(name: str) -> int:
    found = re.search(rf"constexpr int {name} = (\d+);", HEADER.read_text())
    assert found, f"{name} is not defined in {HEADER.name}"
    return int(found.group(1))


def test_mirror_constants_match_the_header():
    assert k3_mod.RING_SLOTS == header_constant("kSlots")
    assert k3_mod.X_STAGES == header_constant("kXStages")
    assert k3_mod.COL_TILE == 128


@pytest.mark.parametrize("c", [64, k3_mod.STAGE_CAP])
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
def test_ring_bytes_counts_barriers_slots_and_x_stages(bm, bk, c):
    slots, stages = header_constant("kSlots"), header_constant("kXStages")
    # a full and an empty 8-byte mbarrier per slot and per stage; C + 4
    # value and C + 4 column entries a slot; max(bm, bk) rows of 128
    # floats a stage
    want = (2 * (slots + stages) * 8 + 2 * slots * (c + 4) * 4
            + stages * max(bm, bk) * 128 * 4)
    assert k3_mod.ring_bytes(c, bm=bm, bk=bk) == want
    # the bulk copies' destinations stay on 16-byte boundaries
    assert 2 * (slots + stages) * 8 % 16 == 0 and (c + 4) * 4 % 16 == 0


@pytest.mark.parametrize("c", [64, k3_mod.STAGE_CAP])
@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
def test_ring_fits_a_cta(bm, bk, c):
    assert k3_mod.MAX_SHARED_BYTES == 232448
    assert k3_mod.ring_bytes(c, bm=bm, bk=bk) <= 232448
    # check_staged accepts it
    k3_mod.check_staged(torch.zeros(8, 128), torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4), c=c, bm=bm, bk=bk)


def test_check_staged_refuses_a_ring_over_the_cta():
    x = torch.zeros(8, 128)
    cols, vals = torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    # an 8192-entry slot (the smoke run's hub-row ring) fits even with
    # bm = 16's 8 KB X stages; a 9000-entry one does not at bm = 8
    assert k3_mod.ring_bytes(8192, bm=16, bk=8) <= 232448
    k3_mod.check_staged(x, cols, vals, c=8192, bm=16, bk=8)
    assert k3_mod.ring_bytes(9000, bm=8, bk=8) > 232448
    with pytest.raises(ValueError, match="exceeds"):
        k3_mod.check_staged(x, cols, vals, c=9000, bm=8, bk=8)
    with pytest.raises(ValueError, match="multiple of 128"):
        k3_mod.check_staged(torch.zeros(8, 100), cols, vals, c=64, bm=8,
                            bk=1)


# -- K2: the same ring with the resident descriptor source -------------------

k2_mod = importlib.import_module("repro_torch.kernels.spmm_bcsr_fused")


def test_resident_ring_is_declared_in_the_header():
    text = HEADER.read_text()
    assert "struct Resident" in text and "resident_ring_bytes" in text
    k2_src = (HEADER.parent / "spmm_bcsr_fused.cu").read_text()
    assert "spmm_ring::Resident" in k2_src


@pytest.mark.parametrize("bk", BKS)
@pytest.mark.parametrize("bm", BMS)
def test_resident_ring_bytes_counts_barriers_and_x_stages(bm, bk):
    slots, stages = header_constant("kSlots"), header_constant("kXStages")
    # every barrier of the slot source (the slots' stay unused), no
    # slots, and a stage of max(bm, bk) rows of 128 floats and an MXU
    # step's bm x bk value panel in whole 16-byte units
    panel = -(-bm * bk // 4) * 4
    want = 2 * (slots + stages) * 8 + stages * (max(bm, bk) * 128
                                                + panel) * 4
    assert want % 16 == 0
    assert k2_mod.ring_bytes(bm=bm, bk=bk) == want
    assert want <= 232448
    k2_mod.check_resident(torch.zeros(8, 128), bm=bm, bk=bk)


def test_check_resident_refuses_a_ring_over_the_cta_and_partial_tiles():
    # bk = 128 asks for four 64 KB X stages
    assert k2_mod.ring_bytes(bm=8, bk=128) > 232448
    with pytest.raises(ValueError, match="exceeds"):
        k2_mod.check_resident(torch.zeros(128, 128), bm=8, bk=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        k2_mod.check_resident(torch.zeros(8, 100), bm=8, bk=8)
