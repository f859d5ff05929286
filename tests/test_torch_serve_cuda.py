"""The serving tier on a Hopper card: the input stage's side-stream copy,
batched == solo bit for bit through K3/K4 and K1/K2, and device memory
freed on eviction without the cycle collector.  These import nothing of
the reference (the card's machine has no JAX) and skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import JitCache, random_csr
from repro_torch.data import DeviceStage
from repro_torch.launch.serve import SpmmRequest, SpmmServer


def _needs_hopper():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0)):
        pytest.skip("needs a Hopper (sm_90) CUDA device")


def _requests():
    rng = np.random.default_rng(5)
    mats = [random_csr(600, 700, density=0.02, family="powerlaw", seed=1),
            random_csr(700, 500, density=0.03, family="uniform", seed=2),
            random_csr(512, 512, density=24 / 512, family="banded", seed=3)]
    return [SpmmRequest(tenant=f"t{i}", a=a, x=rng.standard_normal(
        (a.n, d)).astype(np.float32)) for i, (a, d) in
        enumerate(zip(mats, (40, 64, 33)))]


@pytest.mark.cuda
def test_cuda_stage_side_stream_copy_equals_the_host_data():
    _needs_hopper()
    rng = np.random.default_rng(0)
    items = [(i, (rng.standard_normal((4096, 128)).astype(np.float32),
                  {"ids": np.arange(1000 * (i + 1))}))
             for i in range(6)]
    with DeviceStage(items, depth=2) as stage:
        assert stage._stream is not None
        assert stage._stream != torch.cuda.current_stream()
        out = list(stage)
    assert [item for item, _ in out] == items
    for (i, (x, d)), (_, (j, (xt, dt))) in zip(items, out):
        assert i == j and xt.is_cuda and dt["ids"].is_cuda
        # consume on the current stream, as a kernel would
        assert torch.equal(xt * 1.0, torch.from_numpy(x).cuda())
        assert torch.equal(dt["ids"].cpu(), torch.from_numpy(d["ids"]))


@pytest.mark.cuda
@pytest.mark.parametrize("backend,staging,kernel", (
    ("pallas_bcsr", "dma", "spmm_bcsr_fused_staged"),
    ("pallas_ell", "dma", "spmm_ell_fused_staged"),
    ("pallas_bcsr", "resident", "spmm_bcsr_fused"),
    ("pallas_ell", "resident", "spmm_ell_fused")))
def test_cuda_batched_bit_identical_to_solo(backend, staging, kernel):
    _needs_hopper()
    reqs = _requests()
    server = SpmmServer(backend=backend, staging=staging, max_batch=8,
                        cache=JitCache())
    solo = [server.serve([r])[0] for r in reqs]
    launches = getattr(kernels, kernel).launches
    batched = server.serve(reqs)
    torch.cuda.synchronize()
    assert getattr(kernels, kernel).launches == launches + 1
    for s, b in zip(solo, batched):
        assert b.batch_size == len(reqs)
        assert np.array_equal(s.y, b.y), b.tenant


@pytest.mark.cuda
def test_cuda_memory_falls_on_eviction_without_gc():
    _needs_hopper()
    import gc
    reqs = _requests()
    was = gc.isenabled()
    gc.disable()
    try:
        cache = JitCache(capacity=1)
        server = SpmmServer(max_batch=1, cache=cache)
        server.serve([reqs[2]])                 # the banded tenant
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        big = server.warmup(reqs[2].a, 33)._fused
        evicted = sum(t.numel() * t.element_size() for t in vars(big).values()
                      if isinstance(t, torch.Tensor))
        del big
        small = random_csr(64, 64, density=0.05, seed=9)
        server.warmup(small, 8)                 # evicts the banded one
        after = torch.cuda.memory_allocated()
        assert cache.stats()["evictions"] == 1
        assert after <= before - evicted + (1 << 20), (before, after)
        cache.clear()
        assert torch.cuda.memory_allocated() < after
    finally:
        if was:
            gc.enable()
