"""An artifact the jit cache drops dies at once.

The cache holds every artifact; an artifact that held its cache back
(to cache its transposed artifact) made a reference cycle, so a cache
dropped with its artifacts in it kept their device tables until the
cyclic garbage collector ran.  With the cycle collector off, each
artifact kind must die with its cache, on ``cache.clear()`` and on
eviction from ``JitCache(capacity=1)`` as soon as the caller lets go
of it.  The card's form of this check
(``torch.cuda.memory_allocated`` falls) is in
``tests/test_torch_serve_cuda.py`` and ``chip_smoke.py``'s serve phase.
"""
import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import (CSRMatrix, JitCache, compile_batched_spmm,
                              compile_sparse_attention, compile_spmm,
                              random_csr)


@contextlib.contextmanager
def no_cycle_collector():
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _mats():
    return [random_csr(40, 48, density=0.1, family=f, seed=s, device="cpu")
            for f, s in (("uniform", 1), ("powerlaw", 2))]


def _spmm(cache, a, backend="pallas_bcsr"):
    return compile_spmm(a, 16, backend=backend, device="cpu", cache=cache)


def _spmm_with_transpose(cache, a):
    c = _spmm(cache, a)
    x = torch.ones(a.n, 16, requires_grad=True)
    c(a.vals, x).sum().backward()
    assert c._transpose is not None
    return c


def _batched(cache, a):
    return compile_batched_spmm([a, _mats()[1]], 16, device="cpu",
                                cache=cache)


def _attention(cache, a):
    # a mask's weights are non-negative
    mask = CSRMatrix(a.shape, a.row_ptr, a.col_indices, a.vals.abs())
    return compile_sparse_attention(mask, 16, backend="pallas_ell",
                                    device="cpu", cache=cache)


BUILDERS = {"spmm_bcsr": _spmm,
            "spmm_ell": lambda c, a: _spmm(c, a, "pallas_ell"),
            "spmm_ref": lambda c, a: _spmm(c, a, "ref"),
            "spmm_and_transpose": _spmm_with_transpose,
            "batched": _batched, "attention": _attention}


@pytest.mark.parametrize("kind", BUILDERS)
def test_artifact_dies_on_clear_without_the_cycle_collector(kind):
    a = _mats()[0]
    with no_cycle_collector():
        cache = JitCache()
        art = BUILDERS[kind](cache, a)
        refs = [weakref.ref(art)]
        if kind == "spmm_and_transpose":
            refs.append(weakref.ref(art._transpose))
        del art
        assert all(r() is not None for r in refs)    # the cache holds it
        cache.clear()
        assert all(r() is None for r in refs), kind


@pytest.mark.parametrize("kind", BUILDERS)
def test_artifact_dies_on_eviction_without_the_cycle_collector(kind):
    a, b = _mats()
    with no_cycle_collector():
        cache = JitCache(capacity=1)
        ref = weakref.ref(BUILDERS[kind](cache, a))
        other = ("spmm_bcsr" if kind in ("spmm_and_transpose", "batched")
                 else kind)
        BUILDERS[other](cache, b)      # evicts the first artifact
        assert cache.stats()["evictions"] >= 1
        assert ref() is None, kind


@pytest.mark.parametrize("kind", BUILDERS)
def test_artifacts_die_with_their_cache_without_the_cycle_collector(kind):
    """Dropping a cache that still holds artifacts frees them: a strong
    reference from an artifact back to its cache made this a cycle."""
    a = _mats()[0]
    with no_cycle_collector():
        cache = JitCache()
        art = BUILDERS[kind](cache, a)
        refs = [weakref.ref(art), weakref.ref(cache)]
        if kind == "spmm_and_transpose":
            refs.append(weakref.ref(art._transpose))
        del art, cache
        assert all(r() is None for r in refs), kind


def test_artifact_holds_its_cache_weakly():
    a = _mats()[0]
    cache = JitCache()
    c = _spmm(cache, a)
    assert c._cache_ref() is cache
    assert not any(v is cache for v in vars(c).values())


def test_transpose_after_the_cache_is_gone():
    """An artifact compiled into a temporary cache still differentiates:
    its transposed artifact is then built for it alone."""
    a = _mats()[0]
    c = compile_spmm(a, 16, backend="pallas_ell", device="cpu",
                     cache=JitCache())
    assert c._cache_ref() is None
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (a.n, 16)).astype(np.float32)).requires_grad_(True)
    c(a.vals, x).sum().backward()
    want = compile_spmm(a, 16, backend="ref", device="cpu",
                        cache=JitCache())
    x2 = x.detach().clone().requires_grad_(True)
    want(a.vals, x2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)
