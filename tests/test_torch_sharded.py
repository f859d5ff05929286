"""The port's sharded fused path (K8) on a CPU chip mesh: the counterpart
of ``tests/test_sharded_fused.py``.

``chip_mesh(C, device="cpu")`` plays the reference's forced host devices:
each chip runs the kernels' plain versions on its own rows.  Sharded
forwards, dX and dvals must equal the unsharded ones bit for bit across
3 strategies x 2 fused backends x {resident, dma} x C in {1, 2, 3, 4},
on a skewed matrix, a mixed VPU/MXU one and a 2-row matrix that leaves
chips empty; they match the reference's unsharded output (interpret
mode) at rtol = atol = 1e-5; a forward counts C dispatches with the
reference's keys and gives each staged launch its own chip's window.
Sparse attention shards the same way.

The ``cuda``-marked test holds each sharded wrapper to its plain version
on a 4-chip mesh over one card.  A CUDA machine need not have JAX, so
this module imports the reference only inside the tests that compare
with it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded.py
"""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import (ChipMesh, CSRMatrix, chip_mesh,
                              compile_sparse_attention, compile_spmm,
                              mesh_fingerprint, resolve_chip_mesh,
                              sparse_attention, spmm)
from repro_torch.core.jit_cache import JitCache
from repro_torch.core.plan import STRATEGIES
from repro_torch.kernels import ops

ell_mod = importlib.import_module("repro_torch.kernels.spmm_ell_fused")
bcsr_mod = importlib.import_module("repro_torch.kernels.spmm_bcsr_fused")

TOL = dict(rtol=1e-5, atol=1e-5)
FUSED = ("pallas_ell", "pallas_bcsr")
STAGINGS = ("resident", "dma")
CHIPS = (1, 2, 3, 4)
COUNTER = {"pallas_ell": "ell_fused", "pallas_bcsr": "bcsr_fused"}


def skewed_dense(seed=0):
    """tests/test_sharded_fused.py's ``_skewed_csr``: 32 light rows and 8
    heavy ones, so nnz_split multi-segments and chips see unequal rows."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((40, 80), np.float32)
    for i in range(32):
        dense[i, rng.integers(0, 80)] = rng.standard_normal()
    for i in range(32, 40):
        dense[i, rng.choice(80, size=64, replace=False)] = \
            rng.standard_normal(64)
    return dense


def mixed_dense(seed=0, m=48, n=64):
    """tests/test_xshard.py's ``_mixed_csr``: dense block-rows (tagged
    MXU) and a ragged sparse tail (VPU)."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(16):
        j0 = (i // 8) * 16
        dense[i, j0:j0 + 16] = rng.standard_normal(16)
    for i in range(16, m):
        k = rng.integers(1, 4)
        dense[i, rng.choice(n, size=k, replace=False)] = rng.standard_normal(k)
    return dense


def hot_parts(m=64, n=512, hot_nnz=400, seed=0):
    """tests/test_xshard.py's ``_hot_csr``: all the weight in one row."""
    rng = np.random.default_rng(seed)
    lengths = [hot_nnz] + [1] * (m - 1)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    cols = np.concatenate(
        [np.sort(rng.choice(n, size=int(ln), replace=False))
         for ln in lengths]).astype(np.int32)
    vals = rng.standard_normal(int(row_ptr[-1])).astype(np.float32)
    return (m, n), row_ptr, cols, vals


def two_rows_dense():
    """Fewer rows than chips: on C = 4 chips 2 and 3 own no rows."""
    return np.array([[1.5, 0, -2.0, 0, 0.5], [0, 3.0, 0, 0, 0]], np.float32)


def hot(device="cpu"):
    shape, row_ptr, cols, vals = hot_parts()
    return CSRMatrix(shape, row_ptr, cols,
                     torch.from_numpy(vals).to(device))


FIXTURES = {
    "skewed": lambda device="cpu": CSRMatrix.from_dense(
        skewed_dense(2), device=device),
    "mixed": lambda device="cpu": CSRMatrix.from_dense(
        mixed_dense(2, m=56), device=device),
    "two_rows": lambda device="cpu": CSRMatrix.from_dense(
        two_rows_dense(), device=device),
}


def x_for(n, d, seed=3, device="cpu"):
    x = np.random.default_rng(seed).standard_normal((n, d))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def artifact(a, d, backend, staging, chips=None, **kw):
    return compile_spmm(a, d, backend=backend, staging=staging, device="cpu",
                        n_chips=chips, cache=JitCache(), **kw)


# -- bit-identity with the unsharded path ----------------------------------

@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_bit_matches_unsharded(strategy, backend, staging):
    for name, make in FIXTURES.items():
        a = make()
        x = x_for(a.n, 16)
        want = artifact(a, 16, backend, staging,
                        strategy=strategy)(a.vals, x)
        for chips in CHIPS:
            c = artifact(a, 16, backend, staging, chips, strategy=strategy)
            assert c.n_chips == chips and c.x_sharding == "replicated"
            got = c(a.vals, x)
            assert torch.equal(got, want), (name, chips)


def test_empty_chips_launch_and_write_nothing_read():
    a = FIXTURES["two_rows"]()
    x = x_for(a.n, 8)
    for backend, staging in itertools.product(FUSED, STAGINGS):
        c = artifact(a, 8, backend, staging, 4)
        sw = c.sharded_workspace
        assert list(np.diff(sw.bounds)).count(0) >= 2
        ops.reset_dispatch_counts()
        got = c(a.vals, x)
        assert ops.DISPATCH_COUNTS[COUNTER[backend]] == 4
        torch.testing.assert_close(got, a.to_dense() @ x, **TOL)
        # no output row comes from an empty chip's workspace
        chip_of_row = sw.inv_perm // sw.ws_rows
        assert set(chip_of_row.tolist()) <= {0, 1}


# -- parity with the reference ---------------------------------------------

def reference_pair(dense, d, seed=3):
    """The same instance for both packages, and X as numpy."""
    from repro.core import csr as ref_csr
    a = ref_csr.CSRMatrix.from_dense(dense)
    return a, CSRMatrix.from_dense(dense, device="cpu"), \
        x_for(a.n, d, seed).numpy()


@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
def test_sharded_matches_reference(backend, staging):
    from repro.core import spmm as ref_spmm
    from repro.core.jit_cache import JitCache as RefJitCache
    for dense, strategy in itertools.product(
            (skewed_dense(4), mixed_dense(5)), STRATEGIES):
        a, b, x = reference_pair(dense, 20)
        want = ref_spmm(a, x, strategy=strategy, backend=backend,
                        interpret=True, staging=staging, cache=RefJitCache())
        got = spmm(b, torch.from_numpy(x), strategy=strategy,
                   backend=backend, staging=staging, device="cpu",
                   n_chips=3, cache=JitCache())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- dispatch accounting and launch arguments ------------------------------

@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
def test_one_dispatch_per_chip(backend, staging):
    a = FIXTURES["mixed"]()
    x = x_for(a.n, 16)
    key = COUNTER[backend]
    for chips, mt in itertools.product(CHIPS, (0, 16)):
        c = artifact(a, 16, backend, staging, chips, merge_threshold=mt)
        merged = c.sharded_workspace.merge_width > 1
        ops.reset_dispatch_counts()
        c(a.vals, x)
        want = {key: chips, key + "_sharded": 1}
        if staging == "dma":
            want[key + "_dma"] = chips
        if merged:
            want[key + "_merged"] = chips
        assert dict(ops.DISPATCH_COUNTS) == want, (chips, mt)
        c(a.vals, x)
        assert ops.DISPATCH_COUNTS[key] == 2 * chips


class _Spy:
    """Records the windows of each call of a staged kernel."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    @property
    def launches(self):
        return self.fn.launches

    def __call__(self, *args, **kw):
        self.calls.append((kw["span"], kw["cspan"], args[-1].shape[0]))
        return self.fn(*args, **kw)


@pytest.mark.parametrize("backend", FUSED)
def test_each_staged_launch_gets_its_own_chips_window(backend, monkeypatch):
    a = hot()
    x = x_for(a.n, 8)
    mod = ell_mod if backend == "pallas_ell" else bcsr_mod
    name = ("spmm_ell_fused_staged" if backend == "pallas_ell"
            else "spmm_bcsr_fused_staged")
    spy = _Spy(getattr(mod, name))
    monkeypatch.setattr(mod, name, spy)
    c = artifact(a, 8, backend, "dma", 4)
    sw = c.sharded_workspace
    got = c(a.vals, x)
    assert [(s, cs) for s, cs, _ in spy.calls] == list(
        zip(sw.chip_span.tolist(), sw.chip_cspan.tolist()))
    assert len(set(sw.chip_span.tolist())) > 1     # the hot chip differs
    want = artifact(a, 8, backend, "resident")(a.vals, x)
    assert torch.equal(got, want)


def test_zero_window_resolves_every_chip_to_resident():
    # a direct kernel-layer call with a zero window on any chip: "auto"
    # resolves on the smallest window, so every chip runs resident, and
    # an explicit "dma" raises
    a = FIXTURES["mixed"]()
    x = x_for(a.n, 16)
    c = artifact(a, 16, "pallas_ell", "resident", 2)
    operands, knobs = c.sharded_operands(a.vals, x)
    sw = c.sharded_workspace
    spans = (int(sw.chip_span[0]), 0)
    ops.reset_dispatch_counts()
    got = ops.spmm_ell_fused_sharded_op(*operands, **knobs, staging="auto",
                                        span=spans, cspan=sw.chip_cspan)
    assert ops.DISPATCH_COUNTS["ell_fused_dma"] == 0
    want = ell_mod.spmm_ell_fused_sharded(*operands, **knobs)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="windows"):
        ops.spmm_ell_fused_sharded_op(*operands, **knobs, staging="dma",
                                      span=spans, cspan=sw.chip_cspan)


# -- cache keys and resolution ---------------------------------------------

def test_cache_key_distinguishes_meshes():
    a = FIXTURES["mixed"]()
    cache = JitCache()
    kw = dict(backend="pallas_ell", device="cpu", cache=cache)
    c0 = compile_spmm(a, 8, **kw)
    c1 = compile_spmm(a, 8, n_chips=1, **kw)
    c2 = compile_spmm(a, 8, n_chips=2, **kw)
    assert len({id(c0), id(c1), id(c2)}) == 3
    assert cache.stats()["entries"] == 3
    # both spellings of one mesh share one artifact
    assert compile_spmm(a, 8, mesh=chip_mesh(2, device="cpu"), **kw) is c2
    assert compile_spmm(a, 8, mesh=ChipMesh(("cpu", "cpu")), n_chips=2,
                        **kw) is c2
    assert cache.stats()["entries"] == 3
    fps = {mesh_fingerprint(m) for m in (
        chip_mesh(2, device="cpu"), chip_mesh(3, device="cpu"),
        ChipMesh(("cuda:0",) * 2), ChipMesh(("cuda:0", "cuda:1")))}
    assert len(fps) == 4


def test_mesh_resolution_rules():
    assert mesh_fingerprint(None) is None
    assert resolve_chip_mesh(None, None) is None
    m2 = chip_mesh(2, device="cpu")
    assert m2.axis_names == ("chips",) and m2.size == 2
    assert m2.single_device and ChipMesh(("cuda:0",) * 2).single_device
    assert not ChipMesh(("cuda:0", "cuda:1")).single_device
    assert mesh_fingerprint(m2) == (("chips",), ("cpu", "cpu"))
    assert resolve_chip_mesh(m2, 2) is m2
    assert resolve_chip_mesh(None, 3, "cpu") == chip_mesh(3, device="cpu")
    with pytest.raises(ValueError):
        resolve_chip_mesh(m2, 3)                 # n_chips != mesh size
    with pytest.raises(ValueError):
        chip_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        chip_mesh(torch.cuda.device_count() + 1)  # more cards than exist
    with pytest.raises(ValueError):
        ChipMesh(("cpu", "cuda:0"))              # mixed device types
    with pytest.raises(ValueError):
        ChipMesh(())
    with pytest.raises(TypeError):               # a mesh is a ChipMesh
        resolve_chip_mesh(("cpu", "cpu"), None)
    a = FIXTURES["mixed"]()
    with pytest.raises(ValueError):              # a CUDA mesh, CPU artifact
        compile_spmm(a, 8, backend="pallas_ell", device="cpu",
                     mesh=ChipMesh(("cuda:0",) * 2), cache=JitCache())


@pytest.mark.parametrize("backend", ["ref", "dense"])
def test_sharding_rejects_non_fused_backends(backend):
    a = FIXTURES["mixed"]()
    with pytest.raises(ValueError, match="single-device"):
        compile_spmm(a, 8, backend=backend, device="cpu", n_chips=1,
                     cache=JitCache())


def test_auto_backend_resolves_fused_when_sharded():
    a = FIXTURES["skewed"]()
    x = x_for(a.n, 8)
    c = compile_spmm(a, 8, device="cpu", n_chips=2, cache=JitCache())
    assert c.backend == "pallas_ell" and c.n_chips == 2
    assert c.staging == "resident" and c.x_sharding == "replicated"
    assert compile_spmm(a, 8, device="cpu", cache=JitCache()).backend == "ref"
    torch.testing.assert_close(c(a.vals, x), a.to_dense() @ x, rtol=1e-4,
                               atol=1e-4)


def test_cuda_mesh_never_takes_cpu_operands():
    a = FIXTURES["mixed"]()
    c = artifact(a, 16, "pallas_ell", "resident", 2)
    operands, knobs = c.sharded_operands(a.vals, x_for(a.n, 16))
    knobs["mesh"] = ChipMesh(("cuda:0",) * 2)
    for fn in (ell_mod.spmm_ell_fused_sharded,
               ell_mod.spmm_ell_fused_sharded_plain):
        with pytest.raises(ValueError, match="mesh"):
            fn(*operands, **knobs)


# -- gradients -------------------------------------------------------------

@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
def test_sharded_gradients_bit_match_unsharded(backend, staging):
    a = FIXTURES["mixed"]()
    x = x_for(a.n, 12, seed=9)

    def grads(c):
        vals = a.vals.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        torch.tanh(c(vals, xx)).sum().backward()
        return vals.grad, xx.grad

    want = grads(artifact(a, 12, backend, staging))
    for chips in CHIPS:
        c = artifact(a, 12, backend, staging, chips)
        got = grads(c)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert c._transpose.mesh == c.mesh
        assert c._transpose.x_sharding == c.x_sharding


# -- sparse attention ------------------------------------------------------

def weighted_dense(m=48, n=40, density=0.2, seed=3):
    """A random mask with weights in [0.2, 2) and a few empty rows."""
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((m, n)) < density,
                     rng.uniform(0.2, 2.0, (m, n)), 0.0).astype(np.float32)
    dense[0] = rng.uniform(0.2, 2.0, n)        # a heavy row
    dense[5] = 0.0
    return dense


def attn_inputs(m, n, dh, dv, seed=4):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((m, dh), (n, dh), (n, dv)))


@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
def test_sharded_attention_bit_matches_unsharded(backend, staging):
    for dense in (weighted_dense(), np.abs(mixed_dense(6)) + 0.0):
        a = CSRMatrix.from_dense(dense, device="cpu")
        q, k, v = attn_inputs(a.m, a.n, 12, 20)
        want = sparse_attention(a, q, k, v, backend=backend, staging=staging,
                                device="cpu", cache=JitCache())
        for chips in CHIPS:
            ops.reset_dispatch_counts()
            got = sparse_attention(a, q, k, v, backend=backend,
                                   staging=staging, device="cpu",
                                   n_chips=chips, cache=JitCache())
            assert torch.equal(got, want), chips
            assert ops.DISPATCH_COUNTS["attn_fused"] == chips
            assert ops.DISPATCH_COUNTS["attn_fused_sharded"] == 1
            assert ops.DISPATCH_COUNTS["attn_fused_dma"] == (
                chips if staging == "dma" else 0)


@pytest.mark.parametrize("backend", FUSED)
def test_sharded_attention_matches_reference(backend):
    from repro.core import compile_sparse_attention as ref_compile
    from repro.core import csr as ref_csr
    from repro.core.jit_cache import JitCache as RefJitCache
    dense = weighted_dense(seed=8)
    a = ref_csr.CSRMatrix.from_dense(dense)
    b = CSRMatrix.from_dense(dense, device="cpu")
    q, k, v = attn_inputs(a.m, a.n, 12, 20)
    want = ref_compile(a, 12, 20, backend=backend, interpret=True,
                       cache=RefJitCache())(a.vals, q.numpy(), k.numpy(),
                                            v.numpy())
    for staging in STAGINGS:
        c = compile_sparse_attention(b, 12, 20, backend=backend,
                                     staging=staging, device="cpu",
                                     n_chips=3, cache=JitCache())
        got = c(b.vals, q, k, v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sharded_attention_gradients_match_unsharded():
    a = CSRMatrix.from_dense(weighted_dense(seed=9), device="cpu")
    q, k, v = attn_inputs(a.m, a.n, 8, 8)
    grads = []
    for chips in (None, 2):
        c = compile_sparse_attention(a, 8, 8, backend="pallas_bcsr",
                                     device="cpu", n_chips=chips,
                                     cache=JitCache())
        ins = [t.clone().requires_grad_(True) for t in (a.vals, q, k, v)]
        c(*ins).square().sum().backward()
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_attention_pins_replicated_and_keys_the_mesh():
    a = CSRMatrix.from_dense(weighted_dense(), device="cpu")
    cache = JitCache()
    kw = dict(backend="pallas_ell", device="cpu", cache=cache)
    c0 = compile_sparse_attention(a, 8, **kw)
    c2 = compile_sparse_attention(a, 8, n_chips=2, **kw)
    assert c0 is not c2 and cache.stats()["entries"] == 2
    assert compile_sparse_attention(
        a, 8, mesh=chip_mesh(2, device="cpu"), **kw) is c2
    assert c2.sharded_workspace.x_sharding == "replicated"


# -- the CUDA wrappers against their plain versions ------------------------

@pytest.mark.cuda
def test_cuda_sharded_wrappers_match_plain():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")
    from repro_torch import kernels
    mesh = ChipMesh(("cuda:0",) * 4)
    fixtures = {name: make("cuda") for name, make in FIXTURES.items()}
    fixtures["hot"] = hot("cuda")
    for (name, a), backend, staging, x_sharding in itertools.product(
            fixtures.items(), FUSED, STAGINGS, ("replicated", "rows")):
        c = compile_spmm(a, 128, backend=backend, staging=staging,
                         mesh=mesh, x_sharding=x_sharding, cache=JitCache())
        x = x_for(a.n, 128, device="cuda")
        operands, knobs = c.sharded_operands(a.vals, x)
        sw = c.sharded_workspace
        win = (dict(span=sw.chip_span, cspan=sw.chip_cspan)
               if staging == "dma" else {})
        wrapper = getattr(kernels, ("spmm_ell_fused_sharded"
                                    if backend == "pallas_ell"
                                    else "spmm_bcsr_fused_sharded"))
        plain = getattr(kernels, wrapper.__name__ + "_plain")
        before = wrapper.launches
        got = wrapper(*operands, **knobs, staging=staging, **win)
        want = plain(*operands, **knobs, staging=staging, **win)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 4, (name, backend)
        torch.testing.assert_close(got, want, **TOL)
        y = c(a.vals, x)
        y0 = compile_spmm(a, 128, backend=backend, staging=staging,
                          cache=JitCache())(a.vals, x)
        assert torch.equal(y, y0), (name, backend, staging, x_sharding)
    a = CSRMatrix.from_dense(weighted_dense(), device="cuda")
    q, k, v = (t.cuda() for t in attn_inputs(a.m, a.n, 12, 20))
    for backend, staging in itertools.product(FUSED, STAGINGS):
        c = compile_sparse_attention(a, 12, 20, backend=backend,
                                     staging=staging, mesh=mesh,
                                     cache=JitCache())
        operands, knobs = c.sharded_operands(a.vals, q, k, v)
        sw = c.sharded_workspace
        win = (dict(span=sw.chip_span, cspan=sw.chip_cspan)
               if staging == "dma" else {})
        before = kernels.attn_fused_sharded.launches
        got = kernels.attn_fused_sharded(*operands, **knobs, staging=staging,
                                         **win)
        want = kernels.attn_fused_sharded_plain(*operands, **knobs,
                                                staging=staging, **win)
        torch.cuda.synchronize()
        assert kernels.attn_fused_sharded.launches == before + 4
        torch.testing.assert_close(got, want, **TOL)
