"""The port's serving path of the decoder stack — ``prefill``,
``forward_decode`` and the LM ``generate`` driver — against the
reference's, on the CPU.

With the reference's weights carried across
(``tests/torch_model_fixtures.py``), for every ported architecture at
``reduced()``: prefill's logits and caches and three decode steps'
logits match the reference's at rtol = atol = 1e-5 (the same fp32
products in another library; the differences measure ~2e-7), the kpos
tables exactly; greedy ``generate`` gives the reference's tokens
(``np.array_equal``).  The port's own prefill + decode reproduce its
``forward_train`` at the reference test's bar (rtol = atol = 2e-3), also
with the sattn slot on the fused backend's staged plain version (K6's,
the card's default) and past a sliding-window ring's wrap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as ref_serve
from repro.models import Model as RefModel
from repro.models import transformer as ref_transformer
from repro_torch import configs
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model, transformer

from torch_model_fixtures import tokens, weights

ARCHS = configs.all_arch_names()
TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _img(img):
    return (None if img is None else jnp.asarray(img),
            None if img is None else torch.from_numpy(img))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    rcfg, cfg, rp, tp = weights(arch)
    B, S, steps = 2, 8, 3
    tok, img = tokens(cfg, B, S + steps)
    r_img, t_img = _img(img)
    want, r_caches = ref_transformer.prefill(
        rcfg, rp, jnp.asarray(tok[:, :S]), S + 4, image_embeds=r_img)
    with torch.no_grad():
        got, caches = transformer.prefill(
            cfg, tp, torch.from_numpy(tok[:, :S]), S + 4,
            image_embeds=t_img, device="cpu")
    _close(got, want)
    assert set(caches) == set(r_caches)
    for slot, cache in caches.items():
        assert set(cache) == set(r_caches[slot])
        for name, t in cache.items():
            assert tuple(t.shape) == r_caches[slot][name].shape, (slot, name)
            if name == "kpos":
                assert np.array_equal(t.numpy(),
                                      np.asarray(r_caches[slot][name]))
            else:
                _close(t, r_caches[slot][name])
    for step in range(steps):
        pos = S + step
        want, r_caches = ref_transformer.forward_decode(
            rcfg, rp, jnp.asarray(tok[:, pos:pos + 1]), r_caches,
            jnp.int32(pos))
        with torch.no_grad():
            got, caches = transformer.forward_decode(
                cfg, tp, torch.from_numpy(tok[:, pos:pos + 1]), caches, pos,
                device="cpu")
        assert got.shape == (B, 1, cfg.vocab_size)
        _close(got, want)
    for slot, cache in caches.items():
        for name, t in cache.items():
            _close(t, r_caches[slot][name])


def _consistency(cfg, tp, tok, img, S, **train_kw):
    """prefill(S) + decode of the rest against forward_train."""
    B, total = tok.shape
    _, t_img = _img(img)
    with torch.no_grad():
        full, _ = transformer.forward_train(
            cfg, tp, torch.from_numpy(tok), image_embeds=t_img,
            remat="none", device="cpu", **train_kw)
        pre, caches = Model(cfg).prefill(tp, torch.from_numpy(tok[:, :S]),
                                         total + 1, image_embeds=t_img,
                                         device="cpu")
        torch.testing.assert_close(pre, full[:, :S], **DECODE_TOL)
        for pos in range(S, total):
            dec, caches = Model(cfg).decode_step(
                tp, torch.from_numpy(tok[:, pos:pos + 1]), caches, pos,
                device="cpu")
            torch.testing.assert_close(dec, full[:, pos:pos + 1],
                                       **DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_forward_train(arch):
    _, cfg, _, tp = weights(arch, seed=4)
    tok, img = tokens(cfg, 2, 11, seed=4)
    _consistency(cfg, tp, tok, img, 8)


@pytest.mark.parametrize("backend,staging", (("pallas_bcsr", "dma"),
                                             ("pallas_ell", "dma"),
                                             ("pallas_bcsr", "resident")))
def test_sattn_decode_reproduces_the_staged_fused_forward(backend, staging):
    # the card's default lowering: forward_train's sattn slots on the
    # staged kernel (K6's plain version here; K5's under "resident"),
    # prefill/decode on the dense masked fallback; S = 20 reaches past
    # window + global columns
    _, cfg, _, tp = weights("longformer-1.4b", seed=5)
    tok, _ = tokens(cfg, 2, 24, seed=5)
    _consistency(cfg, tp, tok, None, 20, backend=backend, staging=staging)


def test_sliding_window_masks_old_positions():
    _, cfg, _, tp = weights("mixtral-8x7b", seed=6)
    assert cfg.sliding_window == 8
    t1, _ = tokens(cfg, 1, 24, seed=6)
    t2 = t1.copy()
    t2[0, :4] = np.random.default_rng(7).integers(2, cfg.vocab_size, size=4)
    with torch.no_grad():
        l1, _ = transformer.forward_train(cfg, tp, torch.from_numpy(t1),
                                          remat="none", device="cpu")
        l2, _ = transformer.forward_train(cfg, tp, torch.from_numpy(t2),
                                          remat="none", device="cpu")
    # two layers see back 2 x (window - 1) = 14 < 24 - 4 positions
    torch.testing.assert_close(l1[0, -1], l2[0, -1], rtol=1e-4, atol=1e-4)
    assert not torch.allclose(l1[0, 4], l2[0, 4], rtol=1e-4, atol=1e-4)


def test_sliding_window_ring_cache_wraps():
    # prompt 8 fills the 8-slot ring; decoding 9 more overwrites every
    # slot at pos % 8 and stays equal to the full forward and to the
    # reference's decode
    rcfg, cfg, rp, tp = weights("mixtral-8x7b", seed=8)
    tok, _ = tokens(cfg, 2, 17, seed=8)
    assert transformer.attn_cache_len(cfg, 18) == 8
    _consistency(cfg, tp, tok, None, 8)
    _, r_caches = ref_transformer.prefill(rcfg, rp, jnp.asarray(tok[:, :8]),
                                          18)
    with torch.no_grad():
        _, caches = transformer.prefill(cfg, tp, torch.from_numpy(tok[:, :8]),
                                        18, device="cpu")
        for pos in range(8, 17):
            want, r_caches = ref_transformer.forward_decode(
                rcfg, rp, jnp.asarray(tok[:, pos:pos + 1]), r_caches,
                jnp.int32(pos))
            got, caches = transformer.forward_decode(
                cfg, tp, torch.from_numpy(tok[:, pos:pos + 1]), caches, pos,
                device="cpu")
            _close(got, want)
    assert np.array_equal(caches["slot0"]["kpos"][0, 0].numpy(),
                          np.array([16, 9, 10, 11, 12, 13, 14, 15]))


def test_prompt_longer_than_the_ring_decodes_like_forward_train():
    # prompt 11 into the 8-slot ring (11 % 8 != 0): prefill puts position
    # p in slot p % 8, where decode writes it, so each decode step evicts
    # the one position that leaves the window; forward_train is the
    # oracle (the reference's prefill fills slots 0..7 in order, and its
    # decode then evicts rows still inside the window)
    _, cfg, _, tp = weights("mixtral-8x7b", seed=11)
    tok, _ = tokens(cfg, 2, 19, seed=11)
    assert transformer.attn_cache_len(cfg, 20) == 8
    with torch.no_grad():
        _, caches = transformer.prefill(cfg, tp, torch.from_numpy(tok[:, :11]),
                                        20, device="cpu")
    assert np.array_equal(caches["slot0"]["kpos"][0, 0].numpy(),
                          np.array([8, 9, 10, 3, 4, 5, 6, 7]))
    _consistency(cfg, tp, tok, None, 11)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    rcfg, cfg, rp, tp = weights(arch, seed=9)
    prompts, img = tokens(cfg, 2, 8, seed=9)
    r_img, t_img = _img(img)
    want = ref_serve.generate(RefModel(rcfg), rp, jnp.asarray(prompts),
                              gen_len=6, cache_len=15, image_embeds=r_img)
    with torch.no_grad():
        got = serve.generate(Model(cfg), tp, torch.from_numpy(prompts),
                             gen_len=6, cache_len=15, image_embeds=t_img,
                             device="cpu")
    assert got.shape == (2, 14)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_deterministic_per_generator():
    _, cfg, _, tp = weights("qwen3-14b", seed=10)
    prompts, _ = tokens(cfg, 3, 6, seed=10)
    model = Model(cfg)

    def sample(generator=None):
        with torch.no_grad():
            return serve.generate(model, tp, torch.from_numpy(prompts),
                                  gen_len=12, cache_len=20, greedy=False,
                                  generator=generator, device="cpu")

    a = sample(torch.Generator().manual_seed(3))
    b = sample(torch.Generator().manual_seed(3))
    c = sample(torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(sample(), sample())      # the fixed default seed
    assert torch.equal(a[:, :7], sample()[:, :7])   # first token greedy
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ("mixtral-8x7b", "llama-3.2-vision-11b",
                                  "longformer-1.4b"))
def test_arch_cli_runs_on_the_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen",
                       "4"]) == 0
    out = capsys.readouterr().out
    assert f"{arch}-smoke on cpu: generated (2, 12)" in out
