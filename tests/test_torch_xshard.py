"""Row-sharded X (``x_sharding="rows"``) on the port's CPU chip mesh: the
counterpart of ``tests/test_xshard.py``.

The exact-panel exchange is held to a numpy model of the reference's
``all_to_all(split_axis=0, concat_axis=0)``; rows equals replicated bit
for bit on both fused backends x both stagings x C in {1..4}, forward
and dX; the hot-shard instance gives each chip its own staged window,
and only the hot chip walks in chunks.  One subprocess runs the
reference's own sharded path on 4 forced host devices and the port's
4-chip CPU outputs must match it at rtol = atol = 1e-5.
"""
import importlib
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (ChipMesh, CSRMatrix, chip_mesh,
                              compile_sparse_attention, compile_spmm)
from repro_torch.core.jit_cache import JitCache
from repro_torch.core.plan import STRATEGIES
from repro_torch.distributed import (collectives, exact_panel_exchange,
                                     wire_bytes_ratio)
from repro_torch.kernels import ops
from repro_torch.kernels.spmm_ell_fused import staged_walk, staging_geometry
from test_torch_sharded import (CHIPS, COUNTER, FUSED, STAGINGS, TOL, hot,
                                mixed_dense, x_for)

ROOT = Path(__file__).resolve().parents[1]
spmm_mod = importlib.import_module("repro_torch.core.spmm")


def mixed(seed=2, m=56, n=64):
    return CSRMatrix.from_dense(mixed_dense(seed, m=m, n=n), device="cpu")


def rows_artifact(a, d, backend, staging, chips, x_sharding="rows", **kw):
    return compile_spmm(a, d, backend=backend, staging=staging, device="cpu",
                        n_chips=chips, x_sharding=x_sharding,
                        cache=JitCache(), **kw)


# -- the exchange ----------------------------------------------------------

def exchange_case(chips):
    """Random strips and tables, and each chip's workspace under a numpy
    model of all_to_all(split=0, concat=0): chip dst receives block dst
    of every chip's (C, T2, ...) send buffer, in source order."""
    rng = np.random.default_rng(chips)
    P, bk, d, T2, T = 5, 4, 3, 3, 7
    strips = rng.standard_normal((chips, P, bk, d)).astype(np.float32)
    send = rng.integers(0, P, (chips, chips, T2))
    recv = rng.integers(0, chips * T2, (chips, T))
    want = []
    for dst in range(chips):
        buf = np.concatenate([strips[src][send[src, dst]]
                              for src in range(chips)])
        want.append(torch.from_numpy(buf[recv[dst]].reshape(-1, d)))
    return (torch.from_numpy(strips), [torch.from_numpy(s) for s in send],
            [torch.from_numpy(r) for r in recv], want)


@pytest.mark.parametrize("chips", CHIPS)
def test_exchange_matches_an_all_to_all_model(chips):
    strips, send, recv, want = exchange_case(chips)
    mesh = chip_mesh(chips, device="cpu")
    got = exact_panel_exchange(list(strips), send, recv, mesh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("chips", CHIPS)
def test_exchange_takes_the_stacked_strips(chips):
    # the one-gather route reads a stacked (C, P, bk, d) tensor in place
    strips, send, recv, want = exchange_case(chips)
    got = exact_panel_exchange(strips, send, recv,
                               chip_mesh(chips, device="cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("chips", CHIPS)
def test_all_to_all_route_matches_the_model(chips):
    # the route a mesh over several devices takes, run on CPU chips
    strips, send, recv, want = exchange_case(chips)
    got = collectives._exchange_all_to_all(list(strips), send, recv,
                                           chip_mesh(chips, device="cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backend", FUSED)
def test_exchange_builds_each_chips_fetched_panels(backend):
    a = mixed(n=96)
    c = rows_artifact(a, 16, backend, "resident", 3)
    sw = c.sharded_workspace
    x = x_for(a.n, 16)
    strips = c._x_row_strips(c._padded_x(x))
    got = exact_panel_exchange(list(strips), list(c._sharded.x_send),
                               list(c._sharded.x_recv), c.mesh)
    x_rows = strips.reshape(-1, strips.shape[-1])
    for chip, ws in enumerate(got):
        want = x_rows.reshape(-1, sw.bk, x_rows.shape[1])[sw.x_fetch[chip]]
        assert torch.equal(ws, want.reshape(-1, x_rows.shape[1])), chip


def test_exchange_rejects_a_table_per_chip_missing():
    mesh = chip_mesh(2, device="cpu")
    one = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError):
        exact_panel_exchange([one], [torch.zeros((2, 1), dtype=torch.long)],
                             [torch.zeros(1, dtype=torch.long)] * 2, mesh)


def test_wire_bytes_ratio_matches_reference():
    from repro.distributed.collectives import wire_bytes_ratio as ref
    for shape in ((4,), (128, 64), (3, 5, 7)):
        assert wire_bytes_ratio(shape) == ref(shape)


# -- rows equals replicated ------------------------------------------------

@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_rows_bit_identical_to_replicated(strategy, backend, staging):
    a = mixed()
    x = x_for(a.n, 20)
    for chips in CHIPS:
        y_rep = rows_artifact(a, 20, backend, staging, chips, "replicated",
                              strategy=strategy)(a.vals, x)
        y_row = rows_artifact(a, 20, backend, staging, chips,
                              strategy=strategy)(a.vals, x)
        assert torch.equal(y_row, y_rep), chips


@pytest.mark.parametrize("staging", STAGINGS)
@pytest.mark.parametrize("backend", FUSED)
def test_rows_gradients_bit_match_replicated(backend, staging):
    a = mixed(seed=8, m=48)
    x = x_for(a.n, 12, seed=9)

    def grads(c):
        vals = a.vals.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        torch.tanh(c(vals, xx)).sum().backward()
        return vals.grad, xx.grad

    for chips in CHIPS:
        c_row = rows_artifact(a, 12, backend, staging, chips)
        want = grads(rows_artifact(a, 12, backend, staging, chips,
                                   "replicated"))
        got = grads(c_row)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert c_row._transpose.x_sharding == "rows"


@pytest.mark.parametrize("backend", FUSED)
def test_rows_counts_the_exchange_per_chip(backend):
    a = mixed()
    x = x_for(a.n, 16)
    key = COUNTER[backend]
    for x_sharding, chips in itertools.product(("rows", "replicated"),
                                               CHIPS):
        c = rows_artifact(a, 16, backend, "dma", chips, x_sharding)
        ops.reset_dispatch_counts()
        c(a.vals, x)
        assert ops.DISPATCH_COUNTS[key] == chips
        assert ops.DISPATCH_COUNTS[key + "_xshard"] == (
            chips if x_sharding == "rows" else 0)


# -- specialization identity and the knob's contract -----------------------

def test_cache_keys_on_x_sharding():
    a = mixed()
    cache = JitCache()
    kw = dict(backend="pallas_ell", device="cpu", n_chips=2, cache=cache)
    c_rep = compile_spmm(a, 8, x_sharding="replicated", **kw)
    c_row = compile_spmm(a, 8, x_sharding="rows", **kw)
    assert c_rep is not c_row and cache.stats()["entries"] == 2
    # on the CPU "auto" resolves to replicated, as under interpret mode
    assert compile_spmm(a, 8, x_sharding="auto", **kw) is c_rep
    assert compile_spmm(a, 8, **kw) is c_rep
    assert compile_spmm(a, 8, x_sharding="rows", **kw) is c_row


def test_auto_is_rows_on_a_cuda_mesh_of_several_chips():
    # rows where the chips have memories of their own; where they share
    # one device (one card's chips, the CPU's) it would save no memory
    resolve = spmm_mod._resolve_x_sharding_for
    cards = ChipMesh(("cuda:0", "cuda:1", "cuda:2", "cuda:3"))
    assert resolve("pallas_bcsr", None, cards) == "rows"
    assert resolve("pallas_ell", "auto", cards) == "rows"
    assert resolve("pallas_bcsr", None,
                   ChipMesh(("cuda:0", "cuda:0", "cuda:1"))) == "rows"
    assert resolve("pallas_bcsr", None,
                   ChipMesh(("cuda:0",) * 4)) == "replicated"
    assert resolve("pallas_bcsr", None, ChipMesh(("cuda:0",))) == "replicated"
    assert resolve("pallas_bcsr", None, None) == "replicated"
    assert resolve("pallas_bcsr", None,
                   chip_mesh(4, device="cpu")) == "replicated"
    assert resolve("pallas_ell", "rows",
                   ChipMesh(("cuda:0",) * 4)) == "rows"


def test_x_sharding_knob_contract():
    a = mixed()
    kw = dict(device="cpu", cache=JitCache())
    with pytest.raises(ValueError):      # rows without a mesh
        compile_spmm(a, 8, backend="pallas_ell", x_sharding="rows", **kw)
    with pytest.raises(ValueError):      # the knob is fused-only
        compile_spmm(a, 8, backend="ref", x_sharding="rows", **kw)
    with pytest.raises(ValueError):
        compile_spmm(a, 8, backend="pallas_ell", n_chips=1,
                     x_sharding="cols", **kw)
    assert compile_spmm(a, 8, backend="ref", x_sharding="replicated",
                        **kw).x_sharding == "replicated"


# -- the hot shard's windows -----------------------------------------------

@pytest.mark.parametrize("backend", FUSED)
def test_hot_shard_windows_and_walks(backend):
    a = hot()
    x = x_for(a.n, 8)
    want = compile_spmm(a, 8, backend=backend, staging="resident",
                        device="cpu", cache=JitCache())(a.vals, x)
    for x_sharding in ("replicated", "rows"):
        c = rows_artifact(a, 8, backend, "dma", 4, x_sharding)
        sw = c.sharded_workspace
        assert torch.equal(c(a.vals, x), want), x_sharding
        walks = []
        for chip in range(sw.n_chips):
            span, cspan = int(sw.chip_span[chip]), int(sw.chip_cspan[chip])
            geo = staging_geometry(span, cspan, bm=c.bm, bk=c.bk)
            tables = [torch.from_numpy(t[chip]).long() for t in
                      (sw.blk_tag, sw.blk_off, sw.blk_coff, sw.blk_L)]
            walks.append({it[0] for it in staged_walk(
                *tables, bm=c.bm, bk=c.bk, mw=sw.merge_width, c=geo[0],
                ch=geo[1], kc=geo[2])})
        hot_chip = int(np.argmax(sw.chip_span))
        assert sw.chip_span[hot_chip] > 1024 >= max(
            np.delete(sw.chip_span, hot_chip))
        # only the hot chip walks past the 1024-entry slot in chunks
        assert [w != {"trip"} for w in walks] == [
            chip == hot_chip for chip in range(sw.n_chips)], walks


# -- the reference's own 4-device sharded path -----------------------------

REFERENCE_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    assert len(jax.devices()) == 4
    from repro.core import compile_sparse_attention, compile_spmm
    from repro.core.csr import CSRMatrix
    from repro.core.jit_cache import JitCache
    dense = np.load(sys.argv[1])
    a = CSRMatrix.from_dense(dense["spmm"])
    m = CSRMatrix.from_dense(dense["mask"])
    out = {}
    for backend in ("pallas_ell", "pallas_bcsr"):
        c = compile_spmm(a, 16, backend=backend, interpret=True, n_chips=4,
                         x_sharding="rows", cache=JitCache())
        assert c.x_sharding == "rows" and c.n_chips == 4
        out[backend] = np.asarray(c(jnp.asarray(a.vals), dense["x"]))
        c = compile_sparse_attention(m, 8, 12, backend=backend,
                                     interpret=True, n_chips=4,
                                     cache=JitCache())
        out["attn_" + backend] = np.asarray(c(
            jnp.asarray(m.vals), dense["q"], dense["k"], dense["v"]))
    np.savez(sys.argv[2], **out)
    print("REFERENCE-4DEV-OK")
""")


def test_port_matches_the_references_4_device_sharded_path(tmp_path):
    rng = np.random.default_rng(11)
    spmm_dense = mixed_dense(2, m=56)
    mask = np.where(spmm_dense != 0, np.abs(spmm_dense) + 0.2,
                    0).astype(np.float32)
    inputs = dict(spmm=spmm_dense, mask=mask,
                  x=rng.standard_normal((64, 16)).astype(np.float32),
                  q=rng.standard_normal((56, 8)).astype(np.float32),
                  k=rng.standard_normal((64, 8)).astype(np.float32),
                  v=rng.standard_normal((64, 12)).astype(np.float32))
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(tmp_path / "inputs.npz"),
         str(tmp_path / "reference.npz")], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REFERENCE-4DEV-OK" in out.stdout
    want = np.load(tmp_path / "reference.npz")
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    a = CSRMatrix.from_dense(spmm_dense, device="cpu")
    m = CSRMatrix.from_dense(mask, device="cpu")
    for backend in FUSED:
        for x_sharding in ("rows", "replicated"):
            c = rows_artifact(a, 16, backend, "resident", 4, x_sharding)
            np.testing.assert_allclose(c(a.vals, t["x"]).numpy(),
                                       want[backend], **TOL)
        c = compile_sparse_attention(m, 8, 12, backend=backend, device="cpu",
                                     n_chips=4, cache=JitCache())
        np.testing.assert_allclose(
            c(m.vals, t["q"], t["k"], t["v"]).numpy(),
            want["attn_" + backend], **TOL)
