"""MoE routing as SpMM (``repro_torch.core.moe_spmm``) and the MoE FFN
(``repro_torch.models.moe``) against the reference's, on the CPU.

Routing logits are numpy-seeded normals scaled by 3, whose top-k + 1
largest logits in a row are never within 1e-3 of each other (checked):
no near-ties, so the ids and slots are exactly the reference's
(``np.array_equal``) and the gates match at 1e-6.
``dispatch``/``combine`` match at 1e-5 and ``routing_to_csr``'s tables
are equal.  ``moe_apply_concrete`` on the ``ref``, ``pallas_ell`` and
``pallas_bcsr`` backends (their plain versions here) matches the
reference's in interpret mode at the reference test's bar (rtol 1e-4,
atol 1e-5), and the gather path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moe_spmm as ref_ms
from repro.models import moe as ref_moe
from repro_torch.core import JitCache
from repro_torch.core import moe_spmm as ms
from repro_torch.models import moe

GATE_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)


def setup(T=24, D=16, E=4, F=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, D)).astype(np.float32),
            (3.0 * rng.standard_normal((T, E))).astype(np.float32),
            (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32))


def no_near_ties(logits, k):
    top = np.sort(logits, axis=-1)[:, ::-1][:, :k + 1]
    return np.all(top[:, :-1] - top[:, 1:] > 1e-3)


def routed(logits, k, C):
    want = ref_ms.topk_routing(jnp.asarray(logits), k, C)
    got = ms.topk_routing(torch.from_numpy(logits), k, C)
    return want, got


@pytest.mark.parametrize("k,C", ((1, 6), (2, 12), (2, 3), (3, 16), (2, 2)))
@pytest.mark.parametrize("seed", (0, 1))
def test_topk_routing_matches_reference(k, C, seed):
    _, logits, _, _ = setup(seed=seed)
    assert no_near_ties(logits, k)
    (rg, re, rs), (g, e, s) = routed(logits, k, C)
    assert np.array_equal(e.numpy(), np.asarray(re))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), **GATE_TOL)
    assert int(s.max()) <= C


@pytest.mark.parametrize("k,C", ((1, 6), (2, 12), (2, 3)))
def test_dispatch_and_combine_match_reference(k, C):
    tokens, logits, _, _ = setup(seed=2)
    E = logits.shape[1]
    (rg, re, rs), (g, e, s) = routed(logits, k, C)
    want = ref_ms.dispatch(jnp.asarray(tokens), re, rs, E, C)
    got = ms.dispatch(torch.from_numpy(tokens), e, s, E, C)
    assert got.shape == (E, C, tokens.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # every kept slot holds one token: dispatch copies, it does not sum
    kept = (s < C).numpy()
    rows = got.reshape(E * C, -1)[(e * C + s).numpy()[kept]]
    assert torch.equal(rows, torch.from_numpy(tokens).repeat_interleave(
        k, 0)[torch.from_numpy(kept.reshape(-1))])
    out = np.random.default_rng(3).standard_normal(
        (E, C, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ms.combine(torch.from_numpy(out), g, e, s).numpy(),
        np.asarray(ref_ms.combine(jnp.asarray(out), rg, re, rs)), **TOL)


@pytest.mark.parametrize("k,C", ((1, 6), (2, 12), (2, 3)))
def test_routing_to_csr_tables_match_reference(k, C):
    _, logits, _, _ = setup(seed=4)
    E = logits.shape[1]
    (rg, re, rs), (g, e, s) = routed(logits, k, C)
    want = ref_ms.routing_to_csr(rg, re, rs, E, C)
    got = ms.routing_to_csr(g, e, s, E, C, device="cpu")
    assert got.shape == want.shape
    assert np.array_equal(got.row_ptr, want.row_ptr)
    assert np.array_equal(got.col_indices, want.col_indices)
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(want.vals),
                               **GATE_TOL)
    assert np.all(got.row_lengths <= k)
    assert np.all(np.unique(got.col_indices, return_counts=True)[1] == 1)


def gather_path(tokens, logits, w_up, w_dn, k, C):
    E = w_up.shape[0]
    gates, eids, slots = ms.topk_routing(logits, k, C)
    xe = ms.dispatch(tokens, eids, slots, E, C)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe, w_up))
    return ms.combine(torch.einsum("ecf,efd->ecd", h, w_dn), gates, eids,
                      slots)


@pytest.mark.parametrize("backend", ("ref", "pallas_ell", "pallas_bcsr"))
@pytest.mark.parametrize("k,C", ((2, 12), (1, 4), (3, 16)))
def test_moe_apply_concrete_matches_reference(backend, k, C):
    arrays = setup()
    want = ref_ms.moe_apply_concrete(*map(jnp.asarray, arrays), top_k=k,
                                     capacity=C, backend=backend,
                                     interpret=True)
    tensors = [torch.from_numpy(a) for a in arrays]
    got = ms.moe_apply_concrete(*tensors, top_k=k, capacity=C,
                                backend=backend, device="cpu",
                                cache=JitCache())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(got, gather_path(*tensors, k, C), rtol=1e-4,
                               atol=1e-5)


def test_moe_apply_concrete_keeps_the_reference_default_backend():
    tensors = [torch.from_numpy(a) for a in setup(seed=5)]
    a = ms.moe_apply_concrete(*tensors, top_k=2, capacity=12, device="cpu",
                              cache=JitCache())
    b = ms.moe_apply_concrete(*tensors, top_k=2, capacity=12, backend="ref",
                              device="cpu", cache=JitCache())
    assert torch.equal(a, b)


def test_capacity_overflow_drops_deterministically():
    # all tokens prefer expert 0: capacity forces drops of the latest
    T, E, k, C = 16, 4, 1, 4
    logits = np.zeros((T, E), np.float32)
    logits[:, 0] = 10.0
    (_, re, rs), (_, e, s) = routed(logits, k, C)
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(s[:, 0].numpy(), np.minimum(np.arange(T), C))
    assert torch.all(e == 0)
    tokens = np.random.default_rng(6).standard_normal((T, 8)).astype(
        np.float32)
    xe = ms.dispatch(torch.from_numpy(tokens), e, s, E, C)
    assert torch.equal(xe[0], torch.from_numpy(tokens[:C]))
    assert not torch.any(xe[1:])
    csr = ms.routing_to_csr(torch.ones(T, 1), e, s, E, C, device="cpu")
    assert np.array_equal(csr.row_lengths, (np.arange(T) < C).astype(int))


@pytest.mark.parametrize("seq,k,E,cf", ((16, 2, 4, 1.25), (1, 2, 8, 1.25),
                                        (4096, 2, 8, 1.25), (9, 1, 4, 4.0)))
def test_moe_capacity_matches_reference(seq, k, E, cf):
    assert moe.moe_capacity(seq, k, E, cf) == ref_moe.moe_capacity(
        seq, k, E, cf)


@pytest.mark.parametrize("k,cf", ((2, 1.25), (1, 4.0), (2, 0.5)))
def test_moe_ffn_and_aux_losses_match_reference(k, cf):
    B, S, D, E, F = 2, 12, 16, 4, 32
    rng = np.random.default_rng(7)
    p = {"ln": (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         "router": rng.standard_normal((D, E)).astype(np.float32),
         "w_gate": (0.2 * rng.standard_normal((E, D, F))).astype(np.float32),
         "w_up": (0.2 * rng.standard_normal((E, D, F))).astype(np.float32),
         "w_down": (0.2 * rng.standard_normal((E, F, D))).astype(np.float32)}
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=k, capacity_factor=cf)
    want, want_aux = ref_moe.moe_ffn({n: jnp.asarray(v) for n, v in p.items()},
                                     jnp.asarray(x), **kw)
    got, aux = moe.moe_ffn({n: torch.from_numpy(v) for n, v in p.items()},
                           torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(aux) == set(want_aux) == {"moe_lb_loss", "moe_z_loss"}
    for name in aux:
        np.testing.assert_allclose(aux[name].numpy(),
                                   np.asarray(want_aux[name]), **TOL)
    # the reference's XLA-only moe_shard layout hint is not an option
    with pytest.raises(TypeError, match="shard_ctx"):
        moe.moe_ffn({n: torch.from_numpy(v) for n, v in p.items()},
                    torch.from_numpy(x), shard_ctx={"moe_shard": True}, **kw)
