"""Parity of the port's sharded workspace builder with the reference.

``build_sharded_workspace`` and ``sharded_workspace_row_maps`` are host
numpy code the port copies from ``src/repro/core/plan.py``; these tests
hold the copies to the reference — every array field ``np.array_equal``
(dtype included), every scalar and tuple field equal, the per-chip plans
field by field — across 3 strategies x 2 fused backends x X placement x
C in {1, 2, 3, 4}, plus the hot-shard instance.  The port's verifier
accepts every workspace and rejects a corrupted ``x_recv``.
"""
import itertools

import numpy as np
import pytest

from repro.core import csr as ref_csr
from repro.core import plan as ref_plan
from repro_torch.analysis import verify as port_verify
from repro_torch.core import plan as port_plan
from test_torch_plan import assert_same_fields
from test_xshard import _hot_csr, _mixed_csr

CHIPS = (1, 2, 3, 4)
FUSED = ("pallas_ell", "pallas_bcsr")
PLACEMENTS = ("replicated", "rows")


def skewed(seed=0):
    """tests/test_sharded_fused.py's fixture: 32 light rows and 8 heavy
    rows, so chips see unequal work."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((40, 80), np.float32)
    for i in range(32):
        dense[i, rng.integers(0, 80)] = rng.standard_normal()
    for i in range(32, 40):
        dense[i, rng.choice(80, size=64, replace=False)] = \
            rng.standard_normal(64)
    return ref_csr.CSRMatrix.from_dense(dense)


FIXTURES = {
    "mixed": lambda: _mixed_csr(seed=18, m=56, n=96),
    "skewed": skewed,
    "hot": _hot_csr,
}


def both(a, **kw):
    args = (a.row_ptr, a.col_indices, a.shape, 16)
    return (port_plan.build_sharded_workspace(*args, **kw),
            ref_plan.build_sharded_workspace(*args, **kw))


@pytest.mark.parametrize("x_sharding", PLACEMENTS)
@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("strategy", port_plan.STRATEGIES)
def test_sharded_workspace_matches_reference(strategy, backend, x_sharding):
    for fixture, chips, mt in itertools.product(("mixed", "skewed"), CHIPS,
                                                (0, 16)):
        a = FIXTURES[fixture]()
        ours, theirs = both(a, n_chips=chips, strategy=strategy,
                            backend=backend, x_sharding=x_sharding,
                            merge_threshold=mt)
        where = (fixture, chips, mt)
        assert_same_fields(ours, theirs, str(where))
        assert np.array_equal(port_plan.sharded_workspace_row_maps(ours),
                              ref_plan.sharded_workspace_row_maps(theirs))
        assert port_verify.verify_sharded_workspace(ours, n_cols=a.n) == [], \
            where


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("chips", CHIPS)
def test_hot_shard_workspace_matches_reference(chips, backend):
    a = FIXTURES["hot"]()
    for x_sharding in PLACEMENTS:
        ours, theirs = both(a, n_chips=chips, backend=backend,
                            x_sharding=x_sharding)
        assert_same_fields(ours, theirs, f"hot/{chips}/{x_sharding}")
        assert port_verify.verify_sharded_workspace(ours, n_cols=a.n) == []
    if chips > 1:
        # each chip's window is its own: the cold chips stay small
        assert ours.chip_span.min() < ours.chip_span.max() == ours.max_span


@pytest.mark.parametrize("chips", (3, 4))
def test_empty_chips_get_a_pad_descriptor_and_a_window(chips):
    # a 2-row matrix on more chips than rows: the surplus chips own no
    # rows, yet each holds one pad descriptor (L == 0) and a window of
    # one staging tile, as in the reference
    a = ref_csr.CSRMatrix.from_dense(np.array(
        [[1.0, 0, 2.0, 0], [0, 3.0, 0, 0]], np.float32))
    ours, theirs = both(a, n_chips=chips)
    assert_same_fields(ours, theirs, "two_rows")
    empty = np.flatnonzero(np.diff(ours.bounds) == 0)
    assert empty.size == chips - 2
    assert np.all(ours.blk_L[empty] == 0)
    assert np.all(ours.chip_span[empty] == port_plan.STAGE_TILE)


@pytest.mark.parametrize("backend", FUSED)
def test_verifier_rejects_a_corrupted_receive_table(backend):
    a = FIXTURES["mixed"]()
    sw, _ = both(a, n_chips=3, backend=backend, x_sharding="rows")
    assert port_verify.verify_sharded_workspace(sw, n_cols=a.n) == []
    bad = sw.x_recv.copy()
    bad[1, 1] = (bad[1, 1] + 1) % (sw.n_chips * sw.x_send.shape[2])
    sw.x_recv = bad
    kinds = {v.kind for v in port_verify.verify_sharded_workspace(
        sw, n_cols=a.n) if v.severity == "error"}
    assert "xshard_fetch" in kinds, kinds
    with pytest.raises(port_verify.PlanVerificationError):
        port_verify.check_workspace(sw, n_cols=a.n)


def test_row_maps_invert_the_global_permutation():
    a = FIXTURES["skewed"]()
    sw, _ = both(a, n_chips=3, backend="pallas_bcsr")
    maps = port_plan.sharded_workspace_row_maps(sw)
    assert maps.shape == (sw.n_chips, sw.ws_rows)
    flat = maps.reshape(-1)
    assert np.array_equal(flat[sw.inv_perm], np.arange(a.m))
    assert np.all(np.delete(flat, sw.inv_perm) == a.m)
