"""Parity of the port's host-side plan pipeline with the reference.

The port copies ``core/plan.py`` and ``analysis/verify.py`` and mirrors
``random_csr``/``fingerprint``; these tests hold the copies to the
reference: every plan and workspace table ``np.array_equal``, the
port's verifier clean on every workspace, and the same instance and
cache fingerprint from the same seed.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import csr as ref_csr
from repro.core import plan as ref_plan
from repro.analysis import verify as ref_verify
from repro_torch import convert
from repro_torch.analysis import verify as port_verify
from repro_torch.core import csr as port_csr
from repro_torch.core import plan as port_plan
from test_torch_kernels import mixed_dense

FAMILIES = ("uniform", "powerlaw", "banded", "mixed")


def reference_matrix(family, seed=5):
    if family == "mixed":
        return ref_csr.CSRMatrix.from_dense(mixed_dense(seed))
    return ref_csr.random_csr(61, 70, density=0.12, family=family, seed=seed)


def port_matrix(a):
    return convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                                  np.asarray(a.vals), device="cpu")


def assert_same_fields(ours, theirs, where):
    for f in dataclasses.fields(theirs):
        got, want = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name in ("pack_seconds", "plan_seconds"):
            continue
        if isinstance(want, np.ndarray):
            assert np.array_equal(got, want), (where, f.name)
            assert got.dtype == want.dtype, (where, f.name)
        elif dataclasses.is_dataclass(want):
            assert_same_fields(got, want, f"{where}.{f.name}")
        elif isinstance(want, list):
            assert len(got) == len(want), (where, f.name)
            for i, (g, w) in enumerate(zip(got, want)):
                assert_same_fields(g, w, f"{where}.{f.name}[{i}]")
        else:
            assert got == want, (where, f.name, got, want)


def build(mod, a, backend, strategy, merge_threshold, d=20):
    if backend == "pallas_bcsr":
        plan = mod.build_mixed_plan(a.row_ptr, a.col_indices, a.shape, d,
                                    strategy=strategy,
                                    fingerprint=a.fingerprint)
    else:
        plan = mod.build_plan(a.row_ptr, a.col_indices, a.shape, d,
                              strategy=strategy, fingerprint=a.fingerprint)
    mw = mod.choose_merge_width(a.row_ptr, merge_threshold=merge_threshold)
    return plan, mod.build_fused_workspace(plan, merge_width=mw)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("merge_threshold", (0, 16))
@pytest.mark.parametrize("backend", ("pallas_ell", "pallas_bcsr"))
@pytest.mark.parametrize("strategy", ref_plan.STRATEGIES)
def test_workspace_tables_match_reference(strategy, backend,
                                          merge_threshold, family):
    a = reference_matrix(family)
    b = port_matrix(a)
    ref_p, ref_ws = build(ref_plan, a, backend, strategy, merge_threshold)
    our_p, our_ws = build(port_plan, b, backend, strategy, merge_threshold)
    assert_same_fields(our_p, ref_p, "plan")
    assert_same_fields(our_ws, ref_ws, "workspace")
    assert port_verify.verify_workspace(our_ws, n_cols=b.n) == []
    assert ref_verify.verify_workspace(ref_ws, n_cols=a.n) == []


def test_fixtures_exercise_merging_and_both_tags():
    # the parity sweep above is only as strong as its fixtures: it must
    # reach merged trips and both execution-unit tags
    a = port_matrix(reference_matrix("mixed"))
    _, ws = build(port_plan, a, "pallas_bcsr", "nnz_split", 16)
    assert ws.merge_width > 1
    assert set(np.unique(ws.blk_tag)) == {port_plan.VPU_TAG,
                                         port_plan.MXU_TAG}
    assert np.any(ws.blk_L == 0)


@pytest.mark.parametrize("family", ("uniform", "powerlaw", "banded"))
def test_random_csr_and_fingerprint_match_reference(family):
    a = ref_csr.random_csr(90, 75, density=0.1, family=family, seed=7)
    b = port_csr.random_csr(90, 75, density=0.1, family=family, seed=7,
                            device="cpu")
    assert np.array_equal(b.row_ptr, a.row_ptr)
    assert np.array_equal(b.col_indices, a.col_indices)
    assert np.array_equal(b.vals.numpy(), np.asarray(a.vals))
    assert b.fingerprint == a.fingerprint
    assert port_matrix(a).fingerprint == a.fingerprint


def test_constants_match_reference():
    for name in ("STAGE_TILE", "MAX_MERGE_WIDTH", "VPU_TAG", "MXU_TAG",
                 "STRATEGIES", "PLAN_STAGES"):
        assert getattr(port_plan, name) == getattr(ref_plan, name), name
    from repro.core import ccm as ref_ccm
    from repro_torch.core import ccm as port_ccm
    assert (port_ccm.LANE, port_ccm.VMEM_BYTES) == (ref_ccm.LANE,
                                                    ref_ccm.VMEM_BYTES)
    assert port_verify.VALIDATE_MODES == ref_verify.VALIDATE_MODES
    # tools/lint_invariants.py reads the port's registry for both trees
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import ops as port_ops
    assert port_ops.DISPATCH_KEYS == ref_ops.DISPATCH_KEYS
    assert len(port_ops.DISPATCH_KEYS) == 17


def test_transpose_structure_matches_reference():
    a = ref_csr.random_csr(40, 30, density=0.2, family="uniform", seed=2)
    ref_t, ref_order = a.transpose_structure()
    our_t, our_order = port_matrix(a).transpose_structure()
    assert np.array_equal(our_order, ref_order)
    assert np.array_equal(our_t.row_ptr, ref_t.row_ptr)
    assert np.array_equal(our_t.col_indices, ref_t.col_indices)
    assert np.array_equal(our_t.vals.numpy(), np.asarray(ref_t.vals))


def test_verifier_flags_a_corrupted_port_workspace():
    # the clean verdicts above mean something only if the copy can fire
    a = port_matrix(reference_matrix("mixed"))
    _, ws = build(port_plan, a, "pallas_bcsr", "nnz_split", 0)
    ws.inv_perm[1] = ws.inv_perm[0]
    kinds = {v.kind for v in port_verify.verify_workspace(ws, n_cols=a.n)}
    assert "perm_not_bijective" in kinds
