"""The port's public SpMM path (``compile_spmm`` / ``spmm``) against the
reference's, on the CPU.

Each backend runs on ``device="cpu"`` — the fused ones through their
kernels' plain versions — and is held to the reference's ``spmm`` (the
Pallas backends in interpret mode) at rtol = atol = 1e-5, on inputs
made once with numpy and handed to both packages through ``convert``.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import csr as ref_csr
from repro.core.jit_cache import JitCache as RefJitCache
from repro_torch import convert
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels import ops
from test_torch_kernels import mixed_dense

# the packages' core/__init__ re-export the function ``spmm`` over the
# module of that name
ref_spmm_mod = importlib.import_module("repro.core.spmm")
spmm_mod = importlib.import_module("repro_torch.core.spmm")

TOL = dict(rtol=1e-5, atol=1e-5)
BACKENDS = ("ref", "dense", "pallas_ell", "pallas_bcsr")

FIXTURES = {
    "mixed": lambda: ref_csr.CSRMatrix.from_dense(mixed_dense(6)),
    "powerlaw": lambda: ref_csr.random_csr(37, 45, density=0.12,
                                           family="powerlaw", seed=8),
    "empty": lambda: ref_csr.CSRMatrix.from_dense(np.zeros((20, 30),
                                                           np.float32)),
}


def both(a, d, seed=2):
    """The same instance and X for both packages."""
    x = np.random.default_rng(seed).standard_normal((a.n, d)).astype(
        np.float32)
    b = convert.csr_from_numpy(a.shape, a.row_ptr, a.col_indices,
                               np.asarray(a.vals), device="cpu")
    return x, b, convert.dense_from_numpy(x, device="cpu")


# d = 20 pads to one 128-lane tile; d = 130 to a 256-wide one
@pytest.mark.parametrize("fixture,d", (("mixed", 20), ("mixed", 130),
                                       ("powerlaw", 20), ("empty", 20)))
@pytest.mark.parametrize("backend", BACKENDS)
def test_spmm_matches_reference(backend, fixture, d):
    a = FIXTURES[fixture]()
    x, b, xt = both(a, d)
    want = ref_spmm_mod.spmm(a, x, backend=backend, interpret=True,
                             merge_threshold=16, cache=RefJitCache())
    got = spmm_mod.spmm(b, xt, backend=backend, device="cpu",
                        merge_threshold=16, cache=JitCache())
    assert got.shape == (a.m, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend,key,other", (
    ("pallas_ell", "ell_fused", "bcsr_fused"),
    ("pallas_bcsr", "bcsr_fused", "ell_fused")))
def test_one_dispatch_per_forward(backend, key, other):
    a = FIXTURES["mixed"]()
    _, b, xt = both(a, 16)
    c = spmm_mod.compile_spmm(b, 16, backend=backend, device="cpu",
                              merge_threshold=16, cache=JitCache())
    ops.reset_dispatch_counts()
    c(b.vals, xt)
    assert ops.DISPATCH_COUNTS[key] == 1
    assert ops.DISPATCH_COUNTS[f"{key}_merged"] == 1
    assert ops.DISPATCH_COUNTS[other] == 0
    c(b.vals, xt)
    assert ops.DISPATCH_COUNTS[key] == 2


def test_auto_backend_is_ref_on_cpu():
    a = FIXTURES["powerlaw"]()
    _, b, _ = both(a, 8)
    c = spmm_mod.compile_spmm(b, 8, device="cpu", cache=JitCache())
    assert c.backend == "ref" and c.validate == "full"
    assert c.staging == "resident"


def test_repeat_compile_hits_the_cache():
    a = FIXTURES["mixed"]()
    _, b, _ = both(a, 8)
    cache = JitCache()
    c1 = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                               cache=cache)
    c2 = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                               cache=cache)
    assert c1 is c2
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    c3 = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                               mxu_gain=0.0, cache=cache)
    assert c3 is not c1


def test_cache_key_differs_in_device(monkeypatch):
    # a CUDA artifact cannot be built here, so stand in for the artifact
    # and the resolver: the key must separate the two devices
    a = FIXTURES["mixed"]()
    _, b, _ = both(a, 8)
    cache = JitCache()
    spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                          cache=cache)
    monkeypatch.setattr(spmm_mod, "resolve_device", lambda device: "cuda:0")
    monkeypatch.setattr(spmm_mod, "CompiledSpmm",
                        lambda *args, **kw: ("artifact", kw["device"]))
    art = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr",
                                device="cuda", cache=cache)
    assert art == ("artifact", "cuda:0")
    keys = list(cache._entries)
    assert len(keys) == 2
    differ = [i for i, (k0, k1) in enumerate(zip(*keys)) if k0 != k1]
    # the device, and the staging mode and validate level it resolves
    # ("resident" and "full" on the CPU, "dma" and "off" on the card)
    assert [keys[0][i] for i in differ] == ["cpu", "resident", "full"]
    assert [keys[1][i] for i in differ] == ["cuda:0", "dma", "off"]


# The next two tests keep the names they had when staging="dma" and a
# requires_grad input raised NotImplementedError; they now check that
# neither does: dma runs the staged kernels (tests/test_torch_staging.py
# holds them to the reference) and autograd runs the backward
# (tests/test_torch_grad.py).

def test_staging_dma_raises_not_implemented():
    a = FIXTURES["mixed"]()
    x, b, xt = both(a, 8)
    want = ref_spmm_mod.spmm(a, x, backend="ref", cache=RefJitCache())
    for backend in ("pallas_ell", "pallas_bcsr"):
        got = spmm_mod.spmm(b, xt, backend=backend, device="cpu",
                            staging="dma", cache=JitCache())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        spmm_mod.spmm(b, xt, backend="ref", device="cpu", staging="dma",
                      cache=JitCache())


@pytest.mark.parametrize("grad_of", ("vals", "x"))
def test_requires_grad_raises_not_implemented(grad_of):
    a = FIXTURES["mixed"]()
    _, b, xt = both(a, 8)
    c = spmm_mod.compile_spmm(b, 8, backend="pallas_bcsr", device="cpu",
                              cache=JitCache())
    vals = b.vals.clone().requires_grad_(grad_of == "vals")
    xt = xt.clone().requires_grad_(grad_of == "x")
    c(vals, xt).sum().backward()
    leaf, other = (vals, xt) if grad_of == "vals" else (xt, vals)
    assert leaf.grad is not None and leaf.grad.shape == leaf.shape
    assert other.grad is None


def test_no_cuda_without_device_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    a = FIXTURES["mixed"]()
    _, b, _ = both(a, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmm_mod.compile_spmm(b, 8, cache=JitCache())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.dense_from_numpy(np.zeros((2, 2)))


def test_operands_on_another_device_are_refused():
    a = FIXTURES["mixed"]()
    _, b, xt = both(a, 8)
    c = spmm_mod.compile_spmm(b, 8, backend="ref", device="cpu",
                              cache=JitCache())
    with pytest.raises(ValueError, match="meta"):
        c(b.vals, xt.to("meta"))


def test_knobs_of_later_slices_are_not_accepted():
    import inspect
    params = inspect.signature(spmm_mod.compile_spmm).parameters
    # the reference's interpret knob is the port's device
    assert "interpret" not in params
    assert "device" in params
    # the sharded slice's knobs are in, and the serving slice's
    # (autotuning and the SLA eviction priority)
    for knob in ("mesh", "n_chips", "x_sharding", "autotune", "measure",
                 "candidates", "top_k", "cache_priority"):
        assert knob in params, knob
