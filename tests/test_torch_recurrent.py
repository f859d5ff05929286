"""The port's recurrent slots (``repro_torch.models.mamba``,
``repro_torch.models.rwkv6``) against the reference's, on the CPU.

Weights are the reference's init of the reduced jamba and rwkv6 configs
(period 0 of slot 0), their constant leaves perturbed
(``tests/torch_model_fixtures.py``); inputs are numpy-seeded.  Each
block runs with S <= chunk (one chunk), with S = 4 x chunk at chunk = 8
(the multi-chunk branch: the scan over chunks, and rwkv's checkpointed
chunk body) and as a decode step (S = 1 from the state of a prefix).
Outputs, returned states and the gradients with respect to the input and
every parameter of the slot match at rtol = atol = 1e-5: the same fp32
arithmetic in another library (the port's mamba composes the affine
pairs in a Hillis-Steele order where the reference runs
``lax.associative_scan``'s, so states differ in the last bits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.models import mamba, rwkv6

from torch_model_fixtures import weights

TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 8


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _slot(arch, kind):
    """(reduced config, reference slot params, port slot params), period 0
    of the first ``kind`` slot."""
    rcfg, cfg, rp, tp = weights(arch)
    i = cfg.pattern.index(kind)
    ref = jax.tree.map(lambda a: a[0], rp["period"][f"slot{i}"][kind])
    port = jax.tree.map(lambda t: t[0].clone(), tp["period"][f"slot{i}"][kind])
    return cfg, ref, port


def _x(cfg, B, S, seed=5):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _state_close(got, want):
    assert set(got) == set(want)
    for name in got:
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name])


def _np_state(state):
    return {k: np.asarray(v) for k, v in state.items()}


# -- mamba ---------------------------------------------------------------------

def _mamba_kw(cfg):
    return dict(state_dim=cfg.mamba_state, conv_width=cfg.mamba_conv,
                norm_eps=cfg.norm_eps)


@pytest.mark.parametrize("S", (5, CHUNK, 4 * CHUNK))
def test_mamba_block_matches_reference(S):
    cfg, rp, tp = _slot("jamba-1.5-large-398b", "mamba")
    x = _x(cfg, 2, S)
    want, w_state = ref_mamba.mamba_block(rp, jnp.asarray(x), chunk=CHUNK,
                                          return_state=True, **_mamba_kw(cfg))
    with torch.no_grad():
        got, state = mamba.mamba_block(tp, torch.from_numpy(x), chunk=CHUNK,
                                       return_state=True, **_mamba_kw(cfg))
    _close(got, want)
    _state_close(state, w_state)


def test_mamba_decode_step_matches_reference():
    cfg, rp, tp = _slot("jamba-1.5-large-398b", "mamba")
    x = _x(cfg, 2, 7)
    _, w_state = ref_mamba.mamba_block(rp, jnp.asarray(x[:, :6]),
                                       return_state=True, **_mamba_kw(cfg))
    want, w_next = ref_mamba.mamba_block(rp, jnp.asarray(x[:, 6:]),
                                         init_state=w_state,
                                         return_state=True, **_mamba_kw(cfg))
    init = {k: torch.from_numpy(v.copy())
            for k, v in _np_state(w_state).items()}
    with torch.no_grad():
        got, nxt = mamba.mamba_block(tp, torch.from_numpy(x[:, 6:]),
                                     init_state=init, return_state=True,
                                     **_mamba_kw(cfg))
    _close(got, want)
    _state_close(nxt, w_next)


def test_mamba_chunks_must_divide_the_sequence():
    cfg, _, tp = _slot("jamba-1.5-large-398b", "mamba")
    with pytest.raises(ValueError, match="multiple"):
        mamba.mamba_block(tp, torch.zeros(1, 12, cfg.d_model), chunk=CHUNK,
                          **_mamba_kw(cfg))


def test_mamba_scan_survives_underflow():
    # a = exp(dt·A) underflows to 0 inside a chunk at large dt and N: the
    # affine composition stays finite where a quotient of cumulative
    # products would not
    h0 = torch.ones(1, 3, 4)
    a = torch.full((1, 64, 3, 4), 1e-30)
    b = torch.ones(1, 64, 3, 4)
    states, last = mamba._ssm_chunk(h0, a, b)
    assert torch.isfinite(states).all()
    torch.testing.assert_close(last, torch.full((1, 3, 4), 1.0 + 1e-30))


@pytest.mark.parametrize("S", (CHUNK, 4 * CHUNK))
def test_mamba_block_gradients_match_reference(S):
    cfg, rp, tp = _slot("jamba-1.5-large-398b", "mamba")
    x = _x(cfg, 2, S)
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def ref_fn(p, xx):
        y = ref_mamba.mamba_block(p, xx, chunk=CHUNK, **_mamba_kw(cfg))
        return jnp.sum(y * cot)

    g_p, g_x = jax.grad(ref_fn, argnums=(0, 1))(rp, jnp.asarray(x))
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mamba.mamba_block(params, xt, chunk=CHUNK, **_mamba_kw(cfg))
    (y * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, g_x)
    for name, t in params.items():
        _close(t.grad, g_p[name])


# -- rwkv ----------------------------------------------------------------------

def _rwkv_kw(cfg):
    return dict(num_heads=cfg.num_heads, head_dim=cfg.head_dim,
                norm_eps=cfg.norm_eps)


@pytest.mark.parametrize("S", (5, CHUNK, 4 * CHUNK))
def test_rwkv_block_matches_reference(S):
    cfg, rp, tp = _slot("rwkv6-1.6b", "rwkv")
    x = _x(cfg, 2, S)
    want, w_state = ref_rwkv6.rwkv_block(rp, jnp.asarray(x), chunk=CHUNK,
                                         return_state=True, **_rwkv_kw(cfg))
    with torch.no_grad():
        got, state = rwkv6.rwkv_block(tp, torch.from_numpy(x), chunk=CHUNK,
                                      return_state=True, **_rwkv_kw(cfg))
    _close(got, want)
    _state_close(state, w_state)


@pytest.mark.parametrize("S", (5, 4 * CHUNK))
def test_time_mix_and_channel_mix_match_reference(S):
    cfg, rp, tp = _slot("rwkv6-1.6b", "rwkv")
    x = _x(cfg, 2, S, seed=7)
    want, w_state = ref_rwkv6.time_mix(rp["tm"], jnp.asarray(x), chunk=CHUNK,
                                       return_state=True, **_rwkv_kw(cfg))
    with torch.no_grad():
        got, state = rwkv6.time_mix(tp["tm"], torch.from_numpy(x),
                                    chunk=CHUNK, return_state=True,
                                    **_rwkv_kw(cfg))
    _close(got, want)
    _state_close(state, w_state)
    want, w_state = ref_rwkv6.channel_mix(rp["cm"], jnp.asarray(x),
                                          norm_eps=cfg.norm_eps,
                                          return_state=True)
    with torch.no_grad():
        got, state = rwkv6.channel_mix(tp["cm"], torch.from_numpy(x),
                                       norm_eps=cfg.norm_eps,
                                       return_state=True)
    _close(got, want)
    _state_close(state, w_state)


def test_rwkv_decode_step_matches_reference():
    cfg, rp, tp = _slot("rwkv6-1.6b", "rwkv")
    x = _x(cfg, 2, 7)
    _, w_state = ref_rwkv6.rwkv_block(rp, jnp.asarray(x[:, :6]),
                                      return_state=True, **_rwkv_kw(cfg))
    want, w_next = ref_rwkv6.rwkv_block(rp, jnp.asarray(x[:, 6:]),
                                        init_state=w_state,
                                        return_state=True, **_rwkv_kw(cfg))
    init = {k: torch.from_numpy(v.copy())
            for k, v in _np_state(w_state).items()}
    with torch.no_grad():
        got, nxt = rwkv6.rwkv_block(tp, torch.from_numpy(x[:, 6:]),
                                    init_state=init, return_state=True,
                                    **_rwkv_kw(cfg))
    _close(got, want)
    _state_close(nxt, w_next)


def test_rwkv_chunks_must_divide_the_sequence():
    cfg, _, tp = _slot("rwkv6-1.6b", "rwkv")
    with pytest.raises(ValueError, match="multiple"):
        rwkv6.rwkv_block(tp, torch.zeros(1, 12, cfg.d_model), chunk=CHUNK,
                         **_rwkv_kw(cfg))


@pytest.mark.parametrize("S", (CHUNK, 4 * CHUNK))
def test_rwkv_block_gradients_match_reference(S):
    cfg, rp, tp = _slot("rwkv6-1.6b", "rwkv")
    x = _x(cfg, 2, S)
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def ref_fn(p, xx):
        y = ref_rwkv6.rwkv_block(p, xx, chunk=CHUNK, **_rwkv_kw(cfg))
        return jnp.sum(y * cot)

    g_p, g_x = jax.grad(ref_fn, argnums=(0, 1))(rp, jnp.asarray(x))
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = rwkv6.rwkv_block(params, xt, chunk=CHUNK, **_rwkv_kw(cfg))
    (y * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, g_x)
    for part in ("tm", "cm"):
        for name, t in params[part].items():
            _close(t.grad, g_p[part][name])


def test_rwkv_chunk_body_is_checkpointed(monkeypatch):
    # under autograd each chunk past the first runs through
    # torch.utils.checkpoint, so the backward recomputes its states
    cfg, _, tp = _slot("rwkv6-1.6b", "rwkv")
    calls = []
    real = rwkv6.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(rwkv6, "checkpoint", counted)
    x = torch.from_numpy(_x(cfg, 1, 4 * CHUNK)).requires_grad_(True)
    rwkv6.rwkv_block(tp, x, chunk=CHUNK, **_rwkv_kw(cfg)).sum().backward()
    assert calls == [rwkv6._wkv_chunk] * 4
    with torch.no_grad():
        rwkv6.rwkv_block(tp, x, chunk=CHUNK, **_rwkv_kw(cfg))
    assert len(calls) == 4


# -- bf16 parameters ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "jamba-1.5-large-398b"))
def test_bf16_conversion_keeps_the_reference_float32_leaves(arch):
    import dataclasses
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro.models import transformer as ref_transformer
    from repro_torch import convert
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import Model
    rcfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                               dtype="bfloat16")
    want = jax.eval_shape(lambda r: ref_transformer.init_params(rcfg, r),
                          jax.random.PRNGKey(0))
    _, _, rp, _ = weights(arch)
    got = convert.model_params_from_numpy(
        jax.tree.map(np.asarray, rp), device="cpu", dtype=torch.bfloat16)
    drawn = Model(dataclasses.replace(reduced(get_config(arch)),
                                      dtype="bfloat16")).init(device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for tree in (got, drawn):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert len(flat) == len(flat_w)
        for (path, w), (_, t) in zip(flat_w, flat):
            assert str(t.dtype).split(".")[-1] == str(w.dtype), path
    assert {str(w.dtype) for _, w in flat_w} == {"bfloat16", "float32"}
