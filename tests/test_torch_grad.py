"""The port's backward (``torch.autograd`` through ``CompiledSpmm``)
against the reference's ``custom_vjp`` (``jax.grad``), on the CPU.

dvals is the SDDMM ``sum(dY[rows] * X[cols], -1)`` and dX runs through
the transposed artifact on the forward's own backend and staging mode.
Both are held to ``jax.grad`` of the reference's ``compile_spmm`` (the
Pallas backends in interpret mode) at rtol = atol = 1e-5, and the 2-layer
GCN of ``examples/gnn_graphconv.py`` is held to the same model in JAX
for one training step, with its weights carried across by
``convert.params_from_numpy``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as ref_csr
from repro.core.jit_cache import JitCache as RefJitCache
from repro_torch import convert, gnn
from repro_torch.core import CSRMatrix
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels import ops
from test_torch_staging import both, hub_csr, mixed_csr

ref_spmm_mod = importlib.import_module("repro.core.spmm")
spmm_mod = importlib.import_module("repro_torch.core.spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = (("ref", "resident"), ("dense", "resident"),
         ("pallas_ell", "resident"), ("pallas_ell", "dma"),
         ("pallas_bcsr", "resident"), ("pallas_bcsr", "dma"))


def port_grads(b, xt, g, backend, staging, d, cache=None, **kw):
    c = spmm_mod.compile_spmm(b, d, backend=backend, device="cpu",
                              staging=staging, cache=cache or JitCache(),
                              **kw)
    vals = b.vals.clone().requires_grad_(True)
    x = xt.clone().requires_grad_(True)
    (c(vals, x) * torch.from_numpy(g)).sum().backward()
    return c, vals.grad, x.grad


@pytest.mark.parametrize("backend,staging", CASES)
@pytest.mark.parametrize("fixture", ("mixed", "hub"))
def test_grads_match_reference(fixture, backend, staging):
    a = mixed_csr(seed=8) if fixture == "mixed" else hub_csr(seed=2)
    d = 12
    x, b, xt = both(a, d, seed=9)
    g = np.random.default_rng(10).standard_normal((a.m, d)).astype(
        np.float32)
    c_ref = ref_spmm_mod.compile_spmm(a, d, backend=backend, interpret=True,
                                      staging=staging, merge_threshold=16,
                                      cache=RefJitCache())
    want = jax.grad(lambda v, xx: jnp.sum(c_ref(v, xx) * g),
                    argnums=(0, 1))(jnp.asarray(a.vals), jnp.asarray(x))
    c, dvals, dx = port_grads(b, xt, g, backend, staging, d,
                              merge_threshold=16)
    assert c.staging == staging
    np.testing.assert_allclose(dvals.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[1]), **TOL)


@pytest.mark.parametrize("backend", ("pallas_ell", "pallas_bcsr"))
def test_staged_grads_equal_resident_and_inherit_staging(backend):
    a = mixed_csr(seed=12)
    x, b, xt = both(a, 16, seed=13)
    g = np.random.default_rng(14).standard_normal((a.m, 16)).astype(
        np.float32)
    c_res, dv_res, dx_res = port_grads(b, xt, g, backend, "resident", 16)
    c_dma, dv_dma, dx_dma = port_grads(b, xt, g, backend, "dma", 16)
    assert torch.equal(dv_dma, dv_res) and torch.equal(dx_dma, dx_res)
    assert c_res._transpose.staging == "resident"
    assert c_dma._transpose.staging == "dma"
    assert c_dma._transpose.backend == backend


def test_second_backward_hits_the_transposed_cache_entry():
    a = mixed_csr(seed=15)
    _, b, xt = both(a, 8, seed=16)
    g = np.ones((a.m, 8), np.float32)
    cache = JitCache()
    c, _, dx1 = port_grads(b, xt, g, "pallas_bcsr", "dma", 8, cache=cache)
    t = c._transpose
    assert cache.stats()["misses"] == 2          # "spmm" and "spmmT"
    _, _, dx2 = port_grads(b, xt, g, "pallas_bcsr", "dma", 8, cache=cache)
    assert c._transpose is t and torch.equal(dx1, dx2)
    assert cache.stats()["misses"] == 2
    # a second artifact of the same instance fetches the same transposed
    # artifact from the cache
    other = spmm_mod.CompiledSpmm(b, 8, strategy=c.strategy,
                                  backend="pallas_bcsr", device="cpu",
                                  staging="dma", validate=c.validate,
                                  cache=cache)
    hits = cache.stats()["hits"]
    x = xt.clone().requires_grad_(True)
    other(b.vals, x).sum().backward()
    assert other._transpose is t
    assert cache.stats()["hits"] == hits + 1
    keys = [k for k in cache._entries if k[0] == "spmmT"]
    assert len(keys) == 1 and keys[0][1] == b.fingerprint


def test_no_gradient_work_for_inputs_that_need_none(monkeypatch):
    a = mixed_csr(seed=17)
    _, b, xt = both(a, 8, seed=18)
    c = spmm_mod.compile_spmm(b, 8, backend="pallas_ell", device="cpu",
                              staging="dma", cache=JitCache())
    calls = []
    monkeypatch.setattr(c, "_sddmm", lambda *args: calls.append(1))
    x = xt.clone().requires_grad_(True)
    ops.reset_dispatch_counts()
    c(b.vals, x).sum().backward()
    assert not calls and x.grad is not None
    # one forward and one transposed dispatch, both staged
    assert ops.DISPATCH_COUNTS["ell_fused_dma"] == 2
    # the SDDMM's expansion and pairs were never built
    assert c._rows is None and c._pairs is None


def test_sddmm_chunks_give_the_unchunked_sums(monkeypatch):
    a = mixed_csr(seed=19)
    x, b, xt = both(a, 24, seed=20)
    g = np.random.default_rng(21).standard_normal((a.m, 24)).astype(
        np.float32)
    # the plain backends chunk; the fused ones run K7
    c = spmm_mod.compile_spmm(b, 24, backend="ref", device="cpu",
                              cache=JitCache())
    whole = c._sddmm(torch.from_numpy(g), xt)
    monkeypatch.setattr(spmm_mod, "SDDMM_CHUNK", 24 * 7)   # 7 nonzeros
    assert torch.equal(c._sddmm(torch.from_numpy(g), xt), whole)
    rows = np.repeat(np.arange(a.m), np.diff(a.row_ptr))
    want = (g[rows] * x[a.col_indices]).sum(-1)
    np.testing.assert_allclose(whole.numpy(), want, **TOL)


# -- the GCN of examples/gnn_graphconv.py --------------------------------

N, D_IN, D_H, CLASSES = 256, 16, 32, 2


def community_graph():
    """examples/gnn_graphconv.py's synthetic 2-community graph, features
    and labels, built with the same numpy calls."""
    rng = np.random.default_rng(0)
    labels = (np.arange(N) >= N // 2).astype(np.int32)
    rows, cols = [], []
    for i in range(N):
        for j in range(i + 1, N):
            p = 0.08 if labels[i] == labels[j] else 0.005
            if rng.random() < p:
                rows += [i, j]
                cols += [j, i]
    rows = np.array(rows + list(range(N)))
    cols = np.array(cols + list(range(N)))
    deg = np.bincount(rows, minlength=N).astype(np.float64)
    vals = (1.0 / np.sqrt(deg[rows] * deg[cols])).astype(np.float32)
    feats = rng.standard_normal((N, D_IN)).astype(np.float32)
    feats[:, 0] += labels * 2.0
    return rows, cols, vals, feats, labels


def test_from_coo_matches_reference():
    rows, cols, vals, _, _ = community_graph()
    want = ref_csr.CSRMatrix.from_coo((N, N), rows, cols, vals)
    got = CSRMatrix.from_coo((N, N), rows, cols, vals, device="cpu")
    assert np.array_equal(got.row_ptr, want.row_ptr)
    assert np.array_equal(got.col_indices, want.col_indices)
    assert got.fingerprint == want.fingerprint
    assert np.array_equal(got.vals.numpy(), np.asarray(want.vals))


@pytest.mark.parametrize("backend,staging", (("ref", None),
                                             ("pallas_ell", "dma"),
                                             ("pallas_bcsr", "dma"),
                                             ("pallas_bcsr", "resident")))
def test_gcn_step_matches_reference(backend, staging):
    rows, cols, vals, feats, labels = community_graph()
    w = np.random.default_rng(1)
    params_np = {"w1": (w.standard_normal((D_IN, D_H)) * 0.2).astype(
                     np.float32),
                 "w2": (w.standard_normal((D_H, CLASSES)) * 0.2).astype(
                     np.float32)}

    # the reference model, as the example defines it
    a_ref = ref_csr.CSRMatrix.from_coo((N, N), rows, cols, vals)
    rcache = RefJitCache()
    agg_h = ref_spmm_mod.compile_spmm(a_ref, D_H, backend="ref",
                                      cache=rcache)
    agg_out = ref_spmm_mod.compile_spmm(a_ref, CLASSES, backend="ref",
                                        cache=rcache)
    a_vals = jnp.asarray(a_ref.vals)

    def loss_fn(params):
        h = jax.nn.relu(agg_h(a_vals, jnp.asarray(feats) @ params["w1"]))
        logp = jax.nn.log_softmax(agg_out(a_vals, h @ params["w2"]))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], 1))

    want_loss, want_g = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in params_np.items()})

    a = CSRMatrix.from_coo((N, N), rows, cols, vals, device="cpu")
    cache = JitCache()
    aggs = [spmm_mod.compile_spmm(a, d, backend=backend, device="cpu",
                                  staging=staging, cache=cache)
            for d in (D_H, CLASSES)]
    params = convert.params_from_numpy(params_np, device="cpu")
    ops.reset_dispatch_counts()
    loss = gnn.gcn_loss(params, *aggs, a.vals,
                        torch.from_numpy(feats),
                        torch.from_numpy(labels).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for k in ("w1", "w2"):
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(want_g[k]), **TOL)
    if staging == "dma":
        key = "ell_fused_dma" if backend == "pallas_ell" else "bcsr_fused_dma"
        # two forward aggregations and two dX aggregations
        assert ops.DISPATCH_COUNTS[key] == 4
        assert all(c._transpose.staging == "dma" for c in aggs)
    before = loss.item()
    gnn.sgd_step(params, 0.5)
    assert all(p.grad is None for p in params.values())
    after = gnn.gcn_loss(params, *aggs, a.vals, torch.from_numpy(feats),
                         torch.from_numpy(labels).long()).item()
    assert after < before
