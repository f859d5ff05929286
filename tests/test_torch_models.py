"""The port's configurations, layer functions and decoder stack
(``repro_torch.configs``, ``repro_torch.models``) against the reference's,
on the CPU.

Configurations, ``reduced`` and the shape cells equal the reference's
field for field (the longformer notes name the port's lowering), and so
do the analytic parameter counts.  Each new layer function matches at
rtol = atol = 1e-5 on numpy-seeded inputs.  For every ported
architecture at ``reduced()``, with the reference's weights carried
across (``tests/torch_model_fixtures.py``), ``forward_train``'s logits
and MoE aux and ``Model.loss_fn`` match at rtol = atol = 1e-5: the same
fp32 products in another library, whose differences measure ~2e-7 on
logits of magnitude ~0.6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import transformer as ref_transformer
from repro.models import Model as RefModel
from repro_torch import configs
from repro_torch.configs import get_config, reduced
from repro_torch.models import Model, layers, transformer

from torch_model_fixtures import tokens, weights

ARCHS = configs.all_arch_names()
TOL = dict(rtol=1e-5, atol=1e-5)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    if cfg.name.startswith("longformer-1.4b"):
        d.pop("notes")           # names the port's lowering
    return d


# -- configurations ----------------------------------------------------------

def test_registry_is_the_reference_less_the_recurrent_archs():
    # the registry is the reference's eleven now, the recurrent ones too
    assert ARCHS == sorted(ref_configs.all_arch_names())
    assert len(ARCHS) == 11
    for name, kind in (("jamba-1.5-large-398b", "mamba"),
                       ("rwkv6-1.6b", "rwkv")):
        assert kind in get_config(name).pattern
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_reference(arch):
    ref = ref_configs.get_config(arch)
    cfg = get_config(arch)
    assert _fields(cfg) == _fields(ref)
    assert _fields(reduced(cfg)) == _fields(ref_configs.reduced(ref))
    assert reduced(cfg).capacity_factor == 4.0
    assert reduced(cfg).dtype == "float32"
    for c, r in ((cfg, ref), (reduced(cfg), ref_configs.reduced(ref))):
        assert c.param_count() == r.param_count()
        assert c.active_param_count() == r.active_param_count()
        for prop in ("period_len", "num_periods", "mamba_d_inner",
                     "mamba_dt_rank", "attention_free", "sub_quadratic"):
            assert getattr(c, prop) == getattr(r, prop), prop
        assert [c.ffn_kind(i) for i in range(c.period_len)] == \
            [r.ffn_kind(i) for i in range(r.period_len)]


def test_shapes_and_cell_support_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in ref_configs.SHAPES.items()}
    for arch in ARCHS:
        for name in configs.SHAPES:
            assert configs.cell_supported(
                get_config(arch), configs.SHAPES[name]) == \
                ref_configs.cell_supported(ref_configs.get_config(arch),
                                           ref_configs.SHAPES[name])


# -- layer functions -------------------------------------------------------

def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


ATTN_CASES = {
    # name: (Sq, Sk, causal, window, num_global, chunk_q)
    "causal": (16, 16, True, None, 0, 512),
    "causal_chunked": (16, 16, True, None, 0, 4),
    "window": (16, 16, True, 5, 0, 512),
    "window_chunked": (16, 16, True, 5, 0, 8),
    "window_global": (16, 16, True, 4, 3, 512),
    "window_global_chunked": (16, 16, True, 4, 3, 4),
    "cross": (8, 12, False, None, 0, 512),
    "cross_chunked": (8, 12, False, None, 0, 4),
}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_gqa_attention_matches_reference(case):
    Sq, Sk, causal, window, num_global, chunk_q = ATTN_CASES[case]
    B, H, KV, hd = 2, 4, 2, 8
    q, k, v = (_np(1, B, Sq, H, hd), _np(2, B, Sk, KV, hd),
               _np(3, B, Sk, KV, hd))
    qpos = np.broadcast_to(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, Sq))
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    kw = dict(causal=causal, window=window, num_global=num_global,
              chunk_q=chunk_q)
    want = ref_layers.gqa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos), **kw)
    got = layers.gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(qpos.copy()),
        kv_positions=torch.from_numpy(kpos.copy()), **kw)
    _close(got, want)


@pytest.mark.parametrize("window", (None, 6))
@pytest.mark.parametrize("S,chunk_q", ((8, 16), (16, 4)))
def test_causal_skip_matches_reference(window, S, chunk_q):
    B, H, KV, hd = 2, 4, 2, 8
    q, k, v = _np(4, B, S, H, hd), _np(5, B, S, KV, hd), _np(6, B, S, KV, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = ref_layers.gqa_attention_causal_skip(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        window=window, chunk_q=chunk_q)
    tpos = torch.from_numpy(pos.copy())
    got = layers.gqa_attention_causal_skip(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=tpos, kv_positions=tpos, window=window, chunk_q=chunk_q)
    _close(got, want)
    # and it is the masked attention it skips blocks of
    full = layers.gqa_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=tpos, kv_positions=tpos, causal=True, window=window,
        chunk_q=chunk_q)
    torch.testing.assert_close(got, full, **TOL)


def _attn_params(D, H, KV, hd, seed, *, bias=False, qk_norm=False,
                 cross=False):
    p = {"ln": 1.0 + _np(seed, D, scale=0.1), "wq": _np(seed + 1, D, H, hd,
                                                        scale=0.1),
         "wk": _np(seed + 2, D, KV, hd, scale=0.1),
         "wv": _np(seed + 3, D, KV, hd, scale=0.1),
         "wo": _np(seed + 4, H, hd, D, scale=0.1)}
    if bias:
        p.update(bq=_np(seed + 5, H, hd, scale=0.1),
                 bk=_np(seed + 6, KV, hd, scale=0.1),
                 bv=_np(seed + 7, KV, hd, scale=0.1))
    if qk_norm:
        p.update(q_norm=1.0 + _np(seed + 8, hd, scale=0.1),
                 k_norm=1.0 + _np(seed + 9, hd, scale=0.1))
    if cross:
        p.update(ln_kv=1.0 + _np(seed + 10, D, scale=0.1),
                 gate=np.float32(0.6))
    return p


def _both(p):
    return ({n: jnp.asarray(v) for n, v in p.items()},
            {n: torch.as_tensor(v) for n, v in p.items()})


@pytest.mark.parametrize("variant", ("plain", "bias", "qk_norm", "window",
                                     "chunked_skip"))
def test_self_attention_layer_matches_reference(variant):
    B, S, D, H, KV, hd = 2, 16, 32, 4, 2, 8
    rp, tp = _both(_attn_params(D, H, KV, hd, 10, bias=variant == "bias",
                                qk_norm=variant == "qk_norm"))
    x = _np(20, B, S, D, scale=0.5)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kw = dict(head_dim=hd, num_heads=H, num_kv_heads=KV, rope_theta=1e4,
              window=5 if variant == "window" else None,
              qk_norm=variant == "qk_norm",
              chunk_q=4 if variant == "chunked_skip" else 512,
              causal_skip=variant == "chunked_skip")
    want = ref_layers.self_attention_layer(rp, jnp.asarray(x),
                                           positions=jnp.asarray(pos), **kw)
    got = layers.self_attention_layer(tp, torch.from_numpy(x),
                                      positions=torch.from_numpy(pos.copy()),
                                      **kw)
    _close(got, want)


@pytest.mark.parametrize("qk_norm", (False, True))
def test_cross_attention_layer_matches_reference(qk_norm):
    B, S, I, D, H, KV, hd = 2, 8, 12, 32, 4, 2, 8
    rp, tp = _both(_attn_params(D, H, KV, hd, 30, qk_norm=qk_norm,
                                cross=True))
    x, img = _np(40, B, S, D, scale=0.5), _np(41, B, I, D, scale=0.5)
    kw = dict(head_dim=hd, num_heads=H, num_kv_heads=KV, qk_norm=qk_norm,
              chunk_q=4)
    want = ref_layers.cross_attention_layer(rp, jnp.asarray(x),
                                            jnp.asarray(img), **kw)
    got = layers.cross_attention_layer(tp, torch.from_numpy(x),
                                       torch.from_numpy(img), **kw)
    _close(got, want)


def test_swiglu_mlp_and_layer_norm_match_reference():
    B, S, D, F = 2, 8, 32, 64
    p = {"ln": 1.0 + _np(50, D, scale=0.1), "w_gate": _np(51, D, F, scale=0.2),
         "w_up": _np(52, D, F, scale=0.2), "w_down": _np(53, F, D, scale=0.2)}
    rp, tp = _both(p)
    x = _np(54, B, S, D)
    _close(layers.swiglu_mlp(tp, torch.from_numpy(x)),
           ref_layers.swiglu_mlp(rp, jnp.asarray(x)))
    w, b = 1.0 + _np(55, D, scale=0.1), _np(56, D, scale=0.1)
    _close(layers.layer_norm(torch.from_numpy(x + 3.0), torch.from_numpy(w),
                             torch.from_numpy(b)),
           ref_layers.layer_norm(jnp.asarray(x + 3.0), jnp.asarray(w),
                                 jnp.asarray(b)))


# -- the decoder stack -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_loss_match_reference(arch):
    rcfg, cfg, rp, tp = weights(arch)
    tok, img = tokens(cfg, 2, 17)
    r_img = None if img is None else jnp.asarray(img)
    t_img = None if img is None else torch.from_numpy(img)
    want, r_aux = ref_transformer.forward_train(
        rcfg, rp, jnp.asarray(tok[:, :-1]), image_embeds=r_img,
        remat="none")
    with torch.no_grad():
        got, aux = transformer.forward_train(
            cfg, tp, torch.from_numpy(tok[:, :-1]), image_embeds=t_img,
            remat="none", device="cpu")
    assert got.shape == (2, 16, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    _close(aux["moe_aux"], r_aux["moe_aux"])
    assert (float(aux["moe_aux"]) > 0) == cfg.moe
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if img is not None:
        batch["image_embeds"] = img
    r_loss, r_parts = RefModel(rcfg).loss_fn(
        rp, {k: jnp.asarray(v) for k, v in batch.items()}, remat="none")
    with torch.no_grad():
        loss, parts = Model(cfg).loss_fn(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()},
            remat="none", device="cpu")
    _close(loss, r_loss)
    _close(parts["nll"], r_parts["nll"])
    assert abs(float(loss) - np.log(cfg.vocab_size)) < 0.5


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "longformer-1.4b",
                                  "llama-3.2-vision-11b"))
def test_remat_changes_nothing_and_gradients_flow(arch):
    _, cfg, _, tp = weights(arch, seed=3)
    tok, img = tokens(cfg, 2, 9, seed=3)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:])}
    if img is not None:
        batch["image_embeds"] = torch.from_numpy(img)
    runs = []
    for remat in ("none", "full"):
        params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
        loss, _ = Model(cfg).loss_fn(params, batch, remat=remat,
                                     device="cpu")
        loss.backward()
        runs.append((float(loss.detach()), params))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    for p0, p1 in zip(jax.tree.leaves(runs[0][1]),
                      jax.tree.leaves(runs[1][1])):
        assert p1.grad is not None and torch.isfinite(p1.grad).all()
        torch.testing.assert_close(p0.grad, p1.grad, **TOL)
    if cfg.moe:   # the router learns through the gates and the aux loss
        router = runs[1][1]["period"]["slot0"]["ffn_moe"]["router"]
        assert float(router.grad.abs().sum()) > 0


@pytest.mark.parametrize("remat", ("dots", "minimal"))
def test_remat_takes_none_or_full(remat):
    # the reference's "dots" save policy has no counterpart: refused, not
    # run as "full"
    _, cfg, _, tp = weights("qwen3-14b", seed=3)
    tok, _ = tokens(cfg, 1, 4, seed=3)
    with pytest.raises(ValueError, match="remat"):
        transformer.forward_train(cfg, tp, torch.from_numpy(tok),
                                  remat=remat, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree_and_scales(arch):
    cfg = reduced(get_config(arch))
    rcfg = ref_configs.reduced(ref_configs.get_config(arch))
    # the reference's Model.param_shapes hands the config to eval_shape
    # as a traced argument and fails; its init under eval_shape is what
    # it means
    want = jax.eval_shape(lambda r: ref_transformer.init_params(rcfg, r),
                          jax.random.PRNGKey(0))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    meta = Model(cfg).param_shapes()
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_m = jax.tree_util.tree_flatten_with_path(meta)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_w] == \
        [jax.tree_util.keystr(k) for k, _ in flat_p] == \
        [jax.tree_util.keystr(k) for k, _ in flat_m]
    for (path, w), (_, p), (_, m) in zip(flat_w, flat_p, flat_m):
        assert tuple(p.shape) == tuple(w.shape) == tuple(m.shape), path
        assert str(p.dtype).split(".")[-1] == str(w.dtype), path
        assert m.device.type == "meta"
    # the reference's scales: 0.02, the output projections 0.02/sqrt(2L)
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.05)
    slot0 = params["period"]["slot0"]
    kind = cfg.pattern[0]
    so = 0.02 / (2 * cfg.num_layers) ** 0.5
    out = {"mamba": lambda p: p["out_proj"],
           "rwkv": lambda p: p["tm"]["w_o"]}.get(kind, lambda p: p["wo"])
    assert float(out(slot0[kind]).std()) == pytest.approx(so, rel=0.1)
    again = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(params), jax.tree.leaves(again)))


@pytest.mark.parametrize("shape", ("train_4k", "prefill_32k", "decode_32k"))
def test_input_specs_match_reference(shape):
    for arch in ("llama-3.2-vision-11b", "mixtral-8x7b", "longformer-1.4b"):
        cfg, rcfg = get_config(arch), ref_configs.get_config(arch)
        got = Model(cfg).input_specs(configs.SHAPES[shape], per_pod_batch=2)
        want = RefModel(rcfg).input_specs(ref_configs.SHAPES[shape],
                                          per_pod_batch=2)
        g = jax.tree_util.tree_flatten_with_path(got)[0]
        w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [jax.tree_util.keystr(k) for k, _ in g] == \
            [jax.tree_util.keystr(k) for k, _ in w]
        for (_, a), (_, b) in zip(g, w):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert a.device.type == "meta"


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    cfg = reduced(get_config("qwen2.5-32b"))
    params = Model(cfg).init(device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.forward_train(cfg, params, tok, remat="none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.prefill(cfg, params, tok, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg).init_cache(1, 8)
    from repro_torch.launch.serve import generate
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(Model(cfg), params, tok, gen_len=2, cache_len=7)


def test_sharding_hints_and_recurrent_slots_raise():
    cfg = reduced(get_config("qwen2.5-32b"))
    params = Model(cfg).init(device="cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    # shard_ctx takes a LogicalMesh (tests/test_torch_mesh_step.py runs
    # it); anything else raises
    with pytest.raises(TypeError, match="LogicalMesh"):
        transformer.forward_train(cfg, params, tok, remat="none",
                                  shard_ctx={"mesh": None, "dp": ("data",)},
                                  device="cpu")
    # a hybrid ("mamba", "attn") stack initialises and runs now
    hybrid = dataclasses.replace(cfg, pattern=("mamba", "attn"),
                                 num_layers=4)
    params = Model(hybrid).init(device="cpu")
    assert set(params["period"]["slot0"]) == {"mamba", "ffn_dense"}
    assert params["period"]["slot0"]["mamba"]["A_log"].shape == (
        2, hybrid.mamba_d_inner, hybrid.mamba_state)
    logits, _ = transformer.forward_train(hybrid, params, tok, remat="none",
                                          device="cpu")
    assert logits.shape == (1, 4, hybrid.vocab_size)
