"""The sharded model stack and train step on CPU chips, against the port's
own unsharded path.

- ``make_train_step`` with microbatches and data groups together: a
  (2, 1) mesh at ``microbatches=2`` is the unsharded step at 4, and a
  batch the data axis does not divide is computed once.  The loss is
  bit for bit; the grad norm sums the blocks' squares, in another order
  than the whole leaves', and a last-bit change in it moves the clip
  scale, so parameters are held at 1e-6 of each leaf's largest
  magnitude (AdamW's first step is nearly invariant to the scale).  The
  (2, 2) step of every architecture against the unsharded
  ``microbatches=2`` step, at these bounds, runs in
  ``test_torch_mesh_step_ref{,2,3}.py`` beside the reference's.
- The layout: each chip's resident bytes are its blocks' sum, and a
  replicated leaf on chips that share a device is stored once.
- ``prefill``/``forward_decode`` under ``shard_ctx`` equal the
  unsharded calls bit for bit (they gather each period's weights whole
  and compute every head), decode writing its caches in place;
  ``forward_train`` splits its heads, ``d_ff`` and vocabulary over the
  (2, 2) mesh's model chips, whose partial sums add in another order
  than the whole products: within rtol = atol = 1e-5
  (``tests/test_torch_mesh_tp.py`` holds the split on every
  architecture and mesh).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model, transformer
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves
from repro_torch.train import make_train_step
from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)

REL = 1e-6
FWD_TOL = dict(rtol=0, atol=0)
SPLIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(arch, seed, B=4, S=16):
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, S + 1)))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(
            (rng.standard_normal((B, cfg.num_image_tokens, cfg.d_model))
             * 0.02).astype(np.float32))
    return cfg, model, params, batch


def _sharded(model, params, mesh):
    return sharding.shard_tree(
        params, sharding.param_shardings(model.param_shapes(), mesh))


def _leaves_close(got, want, rel=REL):
    got = tree_leaves(sharding.gather_tree(got, "cpu"))
    want = tree_leaves(want)
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        d = (a.float() - b.float()).abs().max().item() if a.numel() else 0.
        top = b.float().abs().max().item() if b.numel() else 0.
        assert d <= rel * top, (d, top)
        worst = max(worst, d / top if top else 0.0)
    return worst


def test_microbatches_split_into_data_groups():
    # (2, 1) x microbatches 2 = four pieces: the unsharded step at 4
    cfg, model, params, batch = _setup("qwen3-14b", seed=5)
    mesh = make_host_mesh(data=2, model=1, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    sp = _sharded(model, params, mesh)
    step = make_train_step(model, opt, chunk_q=8, microbatches=2,
                           shard_ctx={"mesh": mesh, "dp": ("data",)})
    ref = make_train_step(model, opt, chunk_q=8, microbatches=4,
                          device="cpu")
    new_s, _, m_s = step(sp, opt.init(sp), batch)
    new_u, _, m_u = ref(params, opt.init(params), batch)
    assert float(m_s["loss"]) == float(m_u["loss"])
    _leaves_close(new_s, new_u)
    # a batch the data axis does not divide is computed once
    odd = {k: v[:3] for k, v in batch.items()}
    new_s, _, m_s = make_train_step(
        model, opt, chunk_q=8, shard_ctx={"mesh": mesh, "dp": ("data",)})(
            sp, opt.init(sp), odd)
    new_u, _, m_u = make_train_step(model, opt, chunk_q=8,
                                    device="cpu")(params, opt.init(params),
                                                  odd)
    assert float(m_s["loss"]) == float(m_u["loss"])
    _leaves_close(new_s, new_u)


def test_one_card_mesh_step_is_the_unsharded_step():
    # run_training's default (1, 1) mesh: one piece, its gradients as
    # they come (no float32 accumulation), every leaf one uncopied block
    cfg, model, params, batch = _setup("longformer-1.4b", seed=3)
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    opt = AdamW(learning_rate=1e-3)
    p_shard = sharding.param_shardings(model.param_shapes(), mesh)
    sp = sharding.shard_tree(params, p_shard)
    step = make_train_step(model, opt, chunk_q=8,
                           shard_ctx={"mesh": mesh, "dp": ("data",)},
                           grad_shardings=p_shard)
    ref = make_train_step(model, opt, chunk_q=8, device="cpu")
    new_s, st_s, m_s = step(sp, opt.init(sp), batch)
    new_u, st_u, m_u = ref(params, opt.init(params), batch)
    for k in ("loss", "grad_norm", "nll"):
        assert torch.equal(m_s[k], m_u[k]), k
    for a, b in zip(tree_leaves(sharding.gather_tree((new_s, st_s), "cpu")),
                    tree_leaves((new_u, st_u))):
        assert torch.equal(a, b)


def test_layout_bytes_per_chip_and_one_copy_per_device():
    cfg, model, params, _ = _setup("jamba-1.5-large-398b", seed=1)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    sp = _sharded(model, params, mesh)
    per_chip = sharding.chip_bytes(sp, mesh)
    want = [0] * 4
    storages = {}
    for leaf in tree_leaves(sp, sharding.is_sharded):
        grid = leaf.placement.grid(leaf.ndim)
        assert len(leaf.blocks) == int(np.prod(grid))
        for chip, b in enumerate(leaf.placement.chip_block(leaf.ndim)):
            block = leaf.blocks[b]
            want[chip] += block.numel() * block.element_size()
        for block in leaf.blocks:
            assert tuple(block.shape) == leaf.placement.shard_shape(
                tuple(leaf.shape))
            storages[block.untyped_storage().data_ptr()] = \
                block.untyped_storage().nbytes()
    assert per_chip == want
    # every distinct shard once: the stored bytes are the tree's
    total = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    assert sum(storages.values()) == total
    # a replicated leaf: one block, chips 0-3 all map to it
    ln = sp["final_norm"]
    assert ln.placement.spec == (None,) and len(ln.blocks) == 1
    assert ln.chip_bytes() == [ln.blocks[0].numel() * 4] * 4
    # the placement-level count agrees (the dry run's argument bytes)
    placed = sharding.placed_bytes(
        params, sharding.param_shardings(model.param_shapes(), mesh))
    assert placed == per_chip[0] == max(per_chip)
    assert 4 * placed >= total


def test_gather_is_shard_inverse_and_carries_gradients():
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    full = torch.arange(2 * 8 * 6, dtype=torch.float32).reshape(2, 8, 6)
    for spec in ((), (None, "data"), (None, ("data", "model")),
                 ("model", "data"), (None, "model", "data")):
        st = sharding.shard(full, sharding.Placement(mesh, spec))
        assert torch.equal(sharding.gather(st, "cpu"), full)
        assert all(b.untyped_storage().data_ptr()
                   != full.untyped_storage().data_ptr() for b in st.blocks)
        blocks = [b.requires_grad_(True) for b in st.blocks]
        st = sharding.ShardedTensor(st.placement, st.shape, tuple(blocks))
        g = torch.autograd.grad((sharding.gather(st, "cpu") * full).sum(),
                                blocks)
        back = sharding.ShardedTensor(st.placement, st.shape, g)
        assert torch.equal(sharding.gather(back, "cpu"), full)
        if spec and spec[0] is None:
            per = st.period(1)
            assert torch.equal(sharding.gather(per, "cpu"), full[1])
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard(torch.zeros(3, 5), sharding.Placement(mesh, ("data",)))


@pytest.mark.parametrize("arch", ("longformer-1.4b", "llama-3.2-vision-11b",
                                  "rwkv6-1.6b"))
def test_forward_prefill_and_decode_under_shard_ctx(arch):
    cfg, model, params, batch = _setup(arch, seed=7)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    ctx = {"mesh": mesh, "dp": ("data",)}
    sp = _sharded(model, params, mesh)
    tok, img = batch["tokens"], batch.get("image_embeds")
    with torch.no_grad():
        want, aux = transformer.forward_train(cfg, params, tok,
                                              image_embeds=img, chunk_q=8,
                                              device="cpu")
        got, _ = transformer.forward_train(cfg, sp, tok, image_embeds=img,
                                           chunk_q=8, shard_ctx=ctx)
        torch.testing.assert_close(got, want, **SPLIT_TOL)
        lw, cw = transformer.prefill(cfg, params, tok[:, :8], 16,
                                     image_embeds=img, chunk_q=8,
                                     device="cpu")
        lg, cg = transformer.prefill(cfg, sp, tok[:, :8], 16,
                                     image_embeds=img, chunk_q=8,
                                     shard_ctx=ctx)
        torch.testing.assert_close(lg, lw, **FWD_TOL)
        for a, b in zip(tree_leaves(cg), tree_leaves(cw)):
            torch.testing.assert_close(a, b, **FWD_TOL)
        dw, cw = transformer.forward_decode(cfg, params, tok[:, 8:9], cw,
                                            8, device="cpu")
        dg, cg2 = transformer.forward_decode(cfg, sp, tok[:, 8:9], cg, 8,
                                             shard_ctx=ctx)
        assert cg2 is cg
        torch.testing.assert_close(dg, dw, **FWD_TOL)
        for a, b in zip(tree_leaves(cg), tree_leaves(cw)):
            torch.testing.assert_close(a, b, **FWD_TOL)


def test_sharded_step_refuses_what_it_cannot_run():
    cfg, model, params, batch = _setup("qwen3-14b", seed=2)
    opt = AdamW()
    with pytest.raises(ValueError, match="needs shard_ctx"):
        make_train_step(model, opt, grad_shardings={}, device="cpu")
    with pytest.raises(TypeError, match="LogicalMesh"):
        make_train_step(model, opt, shard_ctx={"mesh": None, "dp": ()})
    split = sharding.LogicalMesh(("data", "model"), (2, 1),
                                 ("cpu", "meta"))
    with pytest.raises(ValueError, match="mixes device types"):
        make_train_step(model, opt, shard_ctx={"mesh": split,
                                               "dp": ("data",)})
    # gradients are born on the parameters' placements: grad_shardings
    # may name no other
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    sp = _sharded(model, params, mesh)
    other = sharding.param_shardings(model.param_shapes(),
                                     make_host_mesh(data=4, model=1,
                                                    device="cpu"))
    step = make_train_step(model, opt, chunk_q=8,
                           shard_ctx={"mesh": mesh, "dp": ("data",)},
                           grad_shardings=other)
    with pytest.raises(ValueError, match="born on"):
        step(sp, opt.init(sp), batch)
