"""The port's ``sattn`` slot (``repro_torch.models``) against the
reference's, on the CPU.

The longformer mask builder matches the reference's structure exactly;
the layer functions it uses (RMS norm, RoPE, Q/K/V projections) match
at rtol = atol = 1e-6; and the whole layer, with the reference's weights
carried across by ``convert.params_from_numpy``, matches the reference's
layer for each backend at the reference test's size (B = 2, S = 16,
D = 32, H = 4, KV = 2, hd = 8): output at 2e-5, weight and input
gradients at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import sparse_attention as ref_sattn
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.jit_cache import GLOBAL_CACHE
from repro_torch.models import layers, sparse_attention

B, S, D, H, KV, HD = 2, 16, 32, 4, 2, 8
WINDOW, GLOBAL = 6, 2


def weights(seed=30):
    """The reference test's layer input and weights, as numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    p = {"ln": (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32),
         "wq": (rng.standard_normal((D, H, HD)) * 0.1).astype(np.float32),
         "wk": (rng.standard_normal((D, KV, HD)) * 0.1).astype(np.float32),
         "wv": (rng.standard_normal((D, KV, HD)) * 0.1).astype(np.float32),
         "wo": (rng.standard_normal((H, HD, D)) * 0.1).astype(np.float32)}
    return x, p


POSITIONS = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))


@pytest.mark.parametrize("shape", ((20, 4, 3), (16, 6, 2), (300, 17, 0),
                                   (64, 512, 64), (1, 1, 1), (700, 32, 64)))
def test_mask_matches_reference(shape):
    want = ref_sattn.sparse_attention_mask(*shape)
    got = sparse_attention.sparse_attention_mask(*shape, device="cpu")
    assert got.shape == want.shape
    assert np.array_equal(got.row_ptr, want.row_ptr)
    assert np.array_equal(got.col_indices, want.col_indices)
    assert torch.equal(got.vals, torch.ones(got.nnz))


def test_longformer_mask_at_full_size_counts():
    a = sparse_attention.sparse_attention_mask(32768, 512, 64, device="cpu")
    assert a.nnz == 18_708_768 and np.all(a.row_lengths >= 1)


def test_config_matches_reference():
    want = ref_get_config("longformer-1.4b")
    got = get_config("longformer-1.4b")
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(want, field.name) or \
            field.name == "notes", field.name
    # every reference arch is registered now, the recurrent ones too; an
    # unknown name still raises
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    assert get_config("rwkv6-1.6b").pattern == ("rwkv",)


def test_layer_functions_match_reference():
    x, p = weights()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = convert.params_from_numpy(p, device="cpu", requires_grad=False)
    h_want = ref_layers.rms_norm(jnp.asarray(x), jp["ln"], 1e-5)
    h = layers.rms_norm(torch.from_numpy(x), tp["ln"], 1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), rtol=1e-6,
                               atol=1e-6)
    qkv_want = ref_layers.attn_project_qkv(jp, h_want, H, KV, HD,
                                           qk_norm=False, norm_eps=1e-5)
    qkv = layers.attn_project_qkv(tp, h, H, KV, HD, qk_norm=False,
                                  norm_eps=1e-5)
    pos = torch.from_numpy(np.ascontiguousarray(POSITIONS))
    for got, want in zip(qkv, qkv_want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(
            layers.apply_rope(got, pos, 1e4).numpy(),
            np.asarray(ref_layers.apply_rope(want, jnp.asarray(POSITIONS),
                                             1e4)), rtol=1e-6, atol=1e-6)


def test_params_from_numpy_keeps_nesting():
    _, p = weights()
    tree = convert.params_from_numpy({"sattn": p, "scale": np.ones(3)},
                                     device="cpu")
    assert set(tree["sattn"]) == set(p)
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in tree["sattn"].values())
    assert torch.equal(tree["sattn"]["wq"], torch.from_numpy(p["wq"]))


def ref_layer_grads(x, p, backend):
    """The reference layer's output and the gradients of
    ``sum(sin(layer))`` for its weights and input."""
    kw = dict(positions=jnp.asarray(POSITIONS), head_dim=HD, num_heads=H,
              num_kv_heads=KV, window=WINDOW, num_global=GLOBAL,
              rope_theta=1e4, backend=backend,
              interpret=None if backend == "ref" else True)

    def f(pp, xx):
        return ref_sattn.sparse_self_attention_layer(pp, xx, **kw)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    y = f(jp, jnp.asarray(x))
    gp, gx = jax.grad(lambda pp, xx: jnp.sum(jnp.sin(f(pp, xx))),
                      argnums=(0, 1))(jp, jnp.asarray(x))
    return np.asarray(y), {k: np.asarray(v) for k, v in gp.items()}, \
        np.asarray(gx)


@pytest.mark.parametrize("backend", ("ref", "pallas_ell", "pallas_bcsr"))
def test_layer_matches_reference(backend):
    x, p = weights()
    y_want, gp_want, gx_want = ref_layer_grads(x, p, backend)
    tp = convert.params_from_numpy(p, device="cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    y = sparse_attention.sparse_self_attention_layer(
        tp, tx, positions=torch.from_numpy(np.ascontiguousarray(POSITIONS)),
        head_dim=HD, num_heads=H, num_kv_heads=KV, window=WINDOW,
        num_global=GLOBAL, rope_theta=1e4, backend=backend, device="cpu")
    np.testing.assert_allclose(y.detach().numpy(), y_want, rtol=2e-5,
                               atol=2e-5)
    torch.sin(y).sum().backward()
    for name, want in gp_want.items():
        np.testing.assert_allclose(tp[name].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), gx_want, rtol=1e-4,
                               atol=1e-4)


def test_layer_shares_one_artifact_per_device_and_backend():
    x, p = weights()
    tp = convert.params_from_numpy(p, device="cpu", requires_grad=False)
    kw = dict(positions=torch.from_numpy(np.ascontiguousarray(POSITIONS)),
              head_dim=HD, num_heads=H, num_kv_heads=KV, window=WINDOW,
              num_global=GLOBAL, device="cpu")
    before = GLOBAL_CACHE.stats()
    for backend in ("pallas_ell", "pallas_ell", "pallas_bcsr"):
        sparse_attention.sparse_self_attention_layer(
            tp, torch.from_numpy(x), backend=backend, **kw)
    a, art = sparse_attention._mask_and_artifact(S, HD, WINDOW, GLOBAL,
                                                 "pallas_ell", "cpu")
    assert art.device == "cpu" and art.backend == "pallas_ell"
    assert sparse_attention._mask_and_artifact(
        S, HD, WINDOW, GLOBAL, "pallas_bcsr", "cpu")[1] is not art
    # the (batch, head) calls reuse the artifact: no new cache entries
    # beyond one per backend
    assert GLOBAL_CACHE.stats()["misses"] - before["misses"] <= 2
    # with no device given the layer runs on the card: without one it
    # raises, with one it refuses CPU operands
    with pytest.raises((RuntimeError, ValueError)):
        sparse_attention.sparse_self_attention_layer(
            tp, torch.from_numpy(x), backend="pallas_ell",
            **dict(kw, device=None))
