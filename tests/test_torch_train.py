"""The port's optimizer, gradient compression and train step
(``repro_torch.optim``, ``repro_torch.train``) against the reference's,
on the CPU.

- ``AdamW.update`` on the same gradients in both packages, three steps
  of a warmup+cosine schedule, a step where clipping bites and one with
  ``clip_norm=None``: updates, moments and the grad norm at rtol = atol
  = 1e-6 (the same float32 formulas; only the order of a sum differs).
- ``compress_decompress`` and the error-feedback transform on identical
  inputs: the int8 codes exactly, scale and residual at 1e-7.
- ``make_train_step`` against the reference's, without a mesh, on the
  reduced rwkv6, jamba, longformer and qwen2.5 with the reference's
  weights, at microbatches 1 and 2: loss, ``nll``, the grad norm and
  every gradient (read before the update through ``grad_transform``) at
  1e-5.  The updated parameters differ where rounding differs: AdamW's
  first step moves a parameter by lr · (g' / (|g'| + eps) + wd · p), g'
  the clipped gradient, and where |g'| is within a few eps of 0 a
  last-bit difference in g' can move that quotient by up to 2, so an
  element by up to 2 · lr.  Where |g'| >= 10 · eps the quotient's
  sensitivity is below eps / |g'|^2 · |δg'| <= 0.1 · |δg'| / |g'|, and
  the params are held at 1e-5; elsewhere within 2 · lr + 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Model as RefModel
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro.train import train_step as ref_train_step
from repro_torch.models import Model
from repro_torch.optim import (AdamW, AdamWState, compress_decompress,
                               make_error_feedback_transform, warmup_cosine)
from repro_torch.optim import compression
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train import (make_prefill_step, make_serve_step,
                               make_train_step)

from torch_model_fixtures import tokens, weights

TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), **(tol or TOL))


def _trees_close(got, want, **tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        _close(a, b, **tol)


def _grads(seed, shapes):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, (shape, scale) in shapes.items()}


SHAPES = {"w": ((8, 5), 1.0), "b": ((5,), 0.1), "emb": ((3, 4), 10.0)}


# -- the schedule and the optimizer ------------------------------------------

@pytest.mark.parametrize("step", (0, 3, 10, 55, 100, 140))
def test_warmup_cosine_matches_reference(step):
    want = ref_adamw.warmup_cosine(3e-4, 10, 100)(jnp.int32(step))
    got = warmup_cosine(3e-4, 10, 100)(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-7, atol=0)


@pytest.mark.parametrize("clip_norm", (1.0, 50.0, None))
def test_adamw_update_matches_reference(clip_norm):
    params = _grads(0, SHAPES)
    kw = dict(learning_rate=warmup_cosine(1e-2, 2, 10), clip_norm=clip_norm)
    ref = ref_adamw.AdamW(**{**kw, "learning_rate":
                             ref_adamw.warmup_cosine(1e-2, 2, 10)})
    opt = AdamW(**kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    r_state, t_state = ref.init(rp), opt.init(tp)
    assert isinstance(t_state, AdamWState)
    assert t_state.count.dtype == torch.int32
    bites = []
    for step in range(3):
        g = _grads(10 + step, SHAPES)
        r_upd, r_state, r_norm = ref.update(
            {k: jnp.asarray(v) for k, v in g.items()}, r_state, rp)
        upd, t_state, norm = opt.update(
            {k: torch.from_numpy(v) for k, v in g.items()}, t_state, tp)
        _trees_close(upd, r_upd, **OPT_TOL)
        _trees_close(t_state.mu, r_state.mu, **OPT_TOL)
        _trees_close(t_state.nu, r_state.nu, **OPT_TOL)
        _close(norm, r_norm, **OPT_TOL)
        assert int(t_state.count) == int(r_state.count) == step + 1
        rp = ref_adamw.AdamW.apply_updates(rp, r_upd)
        tp = AdamW.apply_updates(tp, upd)
        _trees_close(tp, rp, **OPT_TOL)
        bites.append(clip_norm is not None and float(norm) > clip_norm)
    if clip_norm is None:
        assert float(norm) == 0.0
    else:   # the first norm is ~35: clipping bites at 1, not at 50
        assert all(bites) == (clip_norm == 1.0)


def test_adamw_keeps_parameter_dtypes_and_float32_moments():
    opt = AdamW(learning_rate=1e-3)
    params = {"a": torch.ones(4, dtype=torch.bfloat16),
              "b": {"c": torch.ones(2, 3)}}
    state = opt.init(params)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.mu))
    grads = tree_map(lambda p: torch.full_like(p, 0.5), params)
    upd, state, _ = opt.update(grads, state, params)
    new = AdamW.apply_updates(params, upd)
    assert new["a"].dtype == torch.bfloat16
    assert new["b"]["c"].dtype == torch.float32
    assert float(new["b"]["c"][0, 0]) < 1.0


# -- compression ---------------------------------------------------------------

@pytest.mark.parametrize("seed", (0, 1, 2))
def test_compress_decompress_matches_reference(seed):
    g = (np.random.default_rng(seed).standard_normal(1000) * 3.0
         ).astype(np.float32)
    q, scale = compression._quantize(torch.from_numpy(g))
    r_q, r_scale = ref_compression._quantize(jnp.asarray(g))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(r_q))
    _close(scale, r_scale, rtol=1e-7, atol=0)
    g_hat, resid = compress_decompress(torch.from_numpy(g))
    r_hat, r_resid = ref_compression.compress_decompress(jnp.asarray(g))
    _close(g_hat, r_hat, rtol=1e-7, atol=1e-7)
    _close(resid, r_resid, rtol=1e-7, atol=1e-7)


def test_error_feedback_transform_matches_reference():
    init, apply = make_error_feedback_transform()
    r_init, r_apply = ref_compression.make_error_feedback_transform()
    g0 = _grads(0, SHAPES)
    ef = init({k: torch.from_numpy(v) for k, v in g0.items()})
    r_ef = r_init({k: jnp.asarray(v) for k, v in g0.items()})
    for step in range(4):
        g = _grads(20 + step, SHAPES)
        g_hat, ef = apply({k: torch.from_numpy(v) for k, v in g.items()}, ef)
        r_hat, r_ef = r_apply({k: jnp.asarray(v) for k, v in g.items()},
                              r_ef)
        _trees_close(g_hat, r_hat, rtol=1e-7, atol=1e-7)
        _trees_close(ef, r_ef, rtol=1e-7, atol=1e-7)


# -- the train step -------------------------------------------------------------

def _capture(into):
    def transform(grads):
        into.append(grads)
        return grads
    return transform


@pytest.mark.parametrize("microbatches", (1, 2))
@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "longformer-1.4b", "qwen2.5-32b"))
def test_train_step_matches_reference(arch, microbatches):
    rcfg, cfg, rp, tp = weights(arch, seed=4)
    tok, _ = tokens(cfg, 4, 17, seed=4)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    lr, eps = 1e-3, 1e-8
    r_opt = ref_adamw.AdamW(learning_rate=lr, eps=eps)
    opt = AdamW(learning_rate=lr, eps=eps)
    r_grads, t_grads = [], []
    r_step = ref_train_step.make_train_step(
        RefModel(rcfg), r_opt, microbatches=microbatches, chunk_q=8,
        grad_transform=_capture(r_grads))
    step = make_train_step(Model(cfg), opt, microbatches=microbatches,
                           chunk_q=8, grad_transform=_capture(t_grads),
                           device="cpu")
    r_params, _, r_metrics = r_step(rp, r_opt.init(rp),
                                    {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    params, state, metrics = step(tp, opt.init(tp), batch)
    for name in ("loss", "nll", "grad_norm"):
        _close(metrics[name], r_metrics[name])
        assert metrics[name].dtype == torch.float32
    _trees_close(t_grads[0], r_grads[0])
    assert int(state.count) == 1
    # the updated params: 1e-5 where |g'| >= 10 eps, 2 lr elsewhere
    scale = min(1.0, 1.0 / (float(r_metrics["grad_norm"]) + 1e-9))
    for got, want, g in zip(tree_leaves(params), jax.tree.leaves(r_params),
                            jax.tree.leaves(r_grads[0])):
        got, want = _np(got), np.asarray(want)
        firm = np.abs(np.asarray(g)) * scale >= 10 * eps
        diff = np.abs(got - want)
        assert np.all(diff[firm] <= 1e-5 + 1e-5 * np.abs(want[firm]))
        assert np.all(diff[~firm] <= 2 * lr + 1e-5)


def test_train_step_with_compressed_grads_runs_the_transform():
    # the compressed step: the error-feedback transform on the step's
    # gradients; its q/scale/residual are held to the reference on
    # identical inputs above, where a rounding boundary cannot differ
    _, cfg, _, tp = weights("rwkv6-1.6b", seed=4)
    tok, _ = tokens(cfg, 2, 9, seed=4)
    init, apply = make_error_feedback_transform()
    ef = {"state": init(tp)}
    seen = []

    def transform(grads):
        seen.append(grads)
        g_hat, ef["state"] = apply(grads, ef["state"])
        return g_hat

    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(Model(cfg), opt, grad_transform=transform,
                           device="cpu")
    params, state, metrics = step(tp, opt.init(tp),
                                  {"tokens": tok[:, :-1],
                                   "labels": tok[:, 1:]})
    assert np.isfinite(float(metrics["loss"]))
    for g, e in zip(tree_leaves(seen[0]), tree_leaves(ef["state"])):
        g_hat, resid = compress_decompress(g)
        torch.testing.assert_close(e, resid, rtol=0, atol=0)
        assert float(e.abs().max()) <= float(g.abs().max()) / 127 * 0.5001


def test_train_step_refuses_sharding_and_bad_microbatches():
    _, cfg, _, tp = weights("qwen2.5-32b")
    opt = AdamW()
    # a mesh step takes a LogicalMesh, and gradient placements need one
    # (tests/test_torch_mesh_step.py runs the sharded step)
    with pytest.raises(ValueError, match="needs shard_ctx"):
        make_train_step(Model(cfg), opt, grad_shardings={}, device="cpu")
    with pytest.raises(TypeError, match="LogicalMesh"):
        make_train_step(Model(cfg), opt, shard_ctx={"mesh": None},
                        device="cpu")
    tok, _ = tokens(cfg, 2, 5)
    step = make_train_step(Model(cfg), opt, microbatches=3, device="cpu")
    with pytest.raises(ValueError, match="microbatches"):
        step(tp, opt.init(tp), {"tokens": tok[:, :-1], "labels": tok[:, 1:]})


def test_serve_and_prefill_steps_are_the_model_entry_points():
    _, cfg, _, tp = weights("rwkv6-1.6b")
    model = Model(cfg)
    tok, _ = tokens(cfg, 2, 7)
    tok = torch.from_numpy(tok)
    with torch.no_grad():
        logits, caches = make_prefill_step(model, 8, device="cpu")(
            tp, tok[:, :6])
        want, _ = model.prefill(tp, tok[:, :6], 8, device="cpu")
        torch.testing.assert_close(logits, want, rtol=0, atol=0)
        step_logits, _ = make_serve_step(model, device="cpu")(
            tp, tok[:, 6:], caches, 6)
        full, _ = model.prefill(tp, tok, 8, device="cpu")
    torch.testing.assert_close(step_logits, full[:, 6:], **TOL)

