"""The model axis computes: the Megatron split of the sharded stack
(``distributed/model_split.py``) on CPU chips, against the port's
unsharded path.

- Every architecture at ``reduced()`` on the (1, 2), (2, 2) and (1, 4)
  meshes: ``forward_train``'s logits, and one train step's loss, grad
  norm and gradients (gathered from their blocks), against the
  unsharded call and step (``microbatches`` = the data groups) at
  rtol = atol = 1e-5; the updated parameters at 1e-5 where the clipped
  gradient |g'| >= 10 eps and within 2 lr elsewhere (AdamW's first step
  moves an element by lr · g' / (|g'| + eps), which a last-bit
  difference in a g' near 0 can flip).  The weights are the
  reference's init with its constant leaves perturbed
  (``torch_model_fixtures``), so gates, norms and biases all matter.
- The split is real: each model chip gathers 1/tp of every leaf the
  rules split over ``model``; the ``sattn`` slot calls its artifact for
  H/tp heads a chip; routing ids are the unsharded routing's exactly;
  on (1, 4) with KV = 2 each chip computes the one KV head its query
  head reads; a vocabulary that does not divide is computed once; the
  experts split by ``d_ff`` where ``E`` does not divide.
- mamba's x/z slices of ``in_proj`` and rwkv's receptance gate applied
  to the summed output match the unsharded blocks.
- A timed ``SplitTally`` leaves the step bit for bit the untimed one and
  splits its forward and backward by chip (a stand-in clock for the
  CUDA events); a split takes no decode cache.
- The helpers: ``gather_slice`` is indexing of the global tensor and
  carries gradients to the blocks; the vocabulary-parallel
  cross-entropy is ``cross_entropy_loss``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import all_arch_names, get_config, reduced
from repro_torch.core import moe_spmm
from repro_torch.distributed import collectives, sharding
from repro_torch.distributed.model_split import ModelSplit, SplitTally
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model, mamba, model as model_mod, moe
from repro_torch.models import rwkv6, sparse_attention, transformer
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves
from repro_torch.train import make_train_step

from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)
from torch_model_fixtures import tokens, weights

TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = ((1, 2), (2, 2), (1, 4))
LR, EPS = 1e-3, 1e-8


def _batch(cfg, B=2, S=16, seed=3):
    tok, img = tokens(cfg, B, S + 1, seed=seed)
    tok = torch.from_numpy(tok)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if img is not None:
        batch["image_embeds"] = torch.from_numpy(img)
    return batch


def _sharded(model, params, d, m):
    mesh = make_host_mesh(data=d, model=m, device="cpu")
    sp = sharding.shard_tree(
        params, sharding.param_shardings(model.param_shapes(), mesh))
    return mesh, sp


def _capture(into):
    def transform(grads):
        into.append(grads)
        return grads
    return transform


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", all_arch_names())
def test_split_matches_the_unsharded_forward_and_step(arch, shape):
    _, cfg, _, params = weights(arch, seed=5)
    model = Model(cfg)
    batch = _batch(cfg)
    mesh, sp = _sharded(model, params, *shape)
    ctx = {"mesh": mesh, "dp": ("data",)}
    img = batch.get("image_embeds")
    with torch.no_grad():
        want, _ = transformer.forward_train(cfg, params, batch["tokens"],
                                            image_embeds=img, chunk_q=8,
                                            device="cpu")
        got, _ = transformer.forward_train(cfg, sp, batch["tokens"],
                                           image_embeds=img, chunk_q=8,
                                           shard_ctx=ctx)
    torch.testing.assert_close(got, want, **TOL)

    grads_s, grads_u = [], []
    opt = AdamW(learning_rate=LR, eps=EPS)
    step = make_train_step(model, opt, chunk_q=8, shard_ctx=ctx,
                           grad_transform=_capture(grads_s))
    ref = make_train_step(model, opt, chunk_q=8, microbatches=shape[0],
                          grad_transform=_capture(grads_u), device="cpu")
    new_s, _, m_s = step(sp, opt.init(sp), batch)
    new_u, _, m_u = ref(params, opt.init(params), batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_s[k]), float(m_u[k]), **TOL)
    g_s = tree_leaves(sharding.gather_tree(grads_s[0], "cpu"))
    g_u = tree_leaves(grads_u[0])
    assert len(g_s) == len(g_u)
    for a, b in zip(g_s, g_u):
        torch.testing.assert_close(a, b, **TOL)
    scale = min(1.0, 1.0 / (float(m_u["grad_norm"]) + 1e-9))
    for a, b, g in zip(tree_leaves(sharding.gather_tree(new_s, "cpu")),
                       tree_leaves(new_u), g_u):
        firm = g.abs() * scale >= 10 * EPS
        diff = (a - b).abs()
        assert bool((diff[firm] <= 1e-5 + 1e-5 * b.abs()[firm]).all())
        assert bool((diff[~firm] <= 2 * LR + 1e-5).all())


class _Tick:
    """A stand-in for a CUDA event on ``device``: the order it was
    recorded in."""
    clock = 0

    def __init__(self, device):
        _Tick.clock += 1
        self.at = _Tick.clock
        self.device = torch.device(device)

    def elapsed_time(self, later):
        return float(later.at - self.at)


# whether one chip's part of a block runs whole before the next chip's
# in the backward: so for attention, the dense and MoE FFN and the head;
# the recurrent slots' chained loops (mamba's scan after its x_proj sum,
# rwkv's gate after its channel-mix sum) interleave
@pytest.mark.parametrize("arch,whole", (
    ("longformer-1.4b", True), ("mixtral-8x7b", True),
    ("llama-3.2-vision-11b", True), ("jamba-1.5-large-398b", False),
    ("rwkv6-1.6b", False)))
def test_a_timed_tally_splits_the_step_by_chip(arch, whole, monkeypatch):
    from repro_torch.distributed import model_split
    _, cfg, _, params = weights(arch, seed=5)
    model = Model(cfg)
    batch = _batch(cfg)
    mesh, sp = _sharded(model, params, 2, 2)
    opt = AdamW(learning_rate=LR, eps=EPS)
    outs = []
    for timed in (False, True):
        tally = SplitTally(mesh, timed=timed)
        if timed:
            monkeypatch.setattr(model_split, "_event", _Tick)
            monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
        step = make_train_step(model, opt, chunk_q=8, remat="full",
                               shard_ctx={"mesh": mesh, "dp": ("data",),
                                          "tally": tally})
        outs.append(step(sp, opt.init(sp), batch))
    # the marks are the identity: the step is the untimed one, bit for bit
    (p0, _, m0), (p1, _, m1) = outs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    fwd, bwd = tally.chip_ms()
    assert all(t > 0 for t in fwd) and all(t > 0 for t in bwd), (fwd, bwd)
    grads = [c for kind, c, _ in tally.timeline if kind == "grad"]
    assert set(grads) == set(range(mesh.size)) | {None}
    if not whole:
        return
    # between two marks of no chip, one chip's marks run whole before
    # the next chip's, so the time up to a chip's mark is that chip's
    run, seen = None, set()
    for c in grads:
        if c is None:
            run, seen = None, set()
        elif c != run:
            assert c not in seen, grads
            run = c
            seen.add(c)


class _TakeSpy:
    """Records every ``ModelSplit.take``: (the leaf, the model chip, the
    gathered tensor)."""

    def __init__(self, monkeypatch):
        self.calls = []
        take = ModelSplit.take

        def spied(split, leaf, m=None, dim=None, ranges=()):
            out = take(split, leaf, m, dim, ranges)
            self.calls.append((leaf, m, out))
            return out
        monkeypatch.setattr(ModelSplit, "take", spied)

    def per_leaf(self):
        """{leaf id: (leaf, {model chip: elements gathered})} of the
        sharded leaves taken."""
        out = {}
        for leaf, m, got in self.calls:
            if not sharding.is_sharded(leaf):
                continue
            key = (leaf.blocks[0].data_ptr(), tuple(leaf.shape))
            rec = out.setdefault(key, (leaf, {}))[1]
            rec[m] = rec.get(m, 0) + got.numel()
        return out


@pytest.mark.parametrize("arch", ("longformer-1.4b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b", "rwkv6-1.6b",
                                  "llama-3.2-vision-11b"))
@pytest.mark.parametrize("tp", (2, 4))
def test_each_model_chip_gathers_only_its_blocks(arch, tp, monkeypatch):
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    mesh, sp = _sharded(model, params, 1, tp)
    batch = _batch(cfg, B=1)
    spy = _TakeSpy(monkeypatch)
    tally = SplitTally(mesh)
    with torch.no_grad():
        transformer.forward_train(
            cfg, sp, batch["tokens"], image_embeds=batch.get("image_embeds"),
            chunk_q=8, shard_ctx={"mesh": mesh, "dp": ("data",),
                                  "tally": tally})
    split_leaves = 0
    for leaf, per_chip in spy.per_leaf().values():
        if sharding.model_dim(leaf.placement, leaf.ndim) is None:
            continue
        split_leaves += 1
        # every model chip, 1/tp of the leaf each, never the whole leaf
        assert sorted(per_chip) == list(range(tp)), per_chip
        assert all(n * tp == leaf.shape.numel()
                   for n in per_chip.values()), (leaf.shape, per_chip)
    assert split_leaves >= 4
    # the tally saw the same bytes on every chip of the group
    assert all(b > 0 for b in tally.gathered)
    assert tally.sums > 0


def test_sattn_calls_its_artifact_for_its_heads_a_chip(monkeypatch):
    cfg = reduced(get_config("longformer-1.4b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    heads, arts = [], set()
    make = sparse_attention._mask_and_artifact
    make.cache_clear()

    def counting(*args):
        a, art = make(*args)
        arts.add(id(art))

        def call(vals, q, k, v):
            # one call a chip and layer, on each of its (batch, head)s
            heads.extend([q.shape[-2:]] * (q.shape[0] if q.dim() == 3
                                           else 1))
            return art(vals, q, k, v)
        return a, call
    monkeypatch.setattr(sparse_attention, "_mask_and_artifact", counting)
    batch = _batch(cfg, B=1)
    for tp in (2, 4):
        mesh, sp = _sharded(model, params, 1, tp)
        tally = SplitTally(mesh)
        heads.clear()
        with torch.no_grad():
            transformer.forward_train(cfg, sp, batch["tokens"], chunk_q=8,
                                      shard_ctx={"mesh": mesh,
                                                 "dp": ("data",),
                                                 "tally": tally})
        # H heads a layer in all, H / tp on each chip
        assert len(heads) == cfg.num_layers * cfg.num_heads
        assert tally.attn == [cfg.num_layers * cfg.num_heads // tp] * tp
    # the artifact is planned once, whichever chip and split asks
    assert make.cache_info().misses == 1 and len(arts) == 1


def test_routing_ids_are_exact_and_experts_split_by_dff(monkeypatch):
    seen = []
    topk = moe_spmm.topk_routing

    def spied(*args):
        out = topk(*args)
        seen.append(out[1].clone())
        return out
    monkeypatch.setattr(moe_spmm, "topk_routing", spied)
    for E in (4, 3):              # 3 does not divide tp = 2: d_ff splits
        cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")),
                                  num_experts=E)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(E), device="cpu")
        mesh, sp = _sharded(model, params, 1, 2)
        slot = transformer._at(sp["period"], 0)["slot0"]["ffn_moe"]
        by = sharding.model_dim(slot["w_gate"].placement, 3)
        assert by == (0 if E == 4 else 2)
        x = torch.from_numpy(np.random.default_rng(E).standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
        plain = transformer._at(params["period"], 0)["slot0"]["ffn_moe"]
        seen.clear()
        with torch.no_grad():
            want, aux_w = moe.moe_ffn(plain, x, num_experts=E,
                                      top_k=cfg.top_k)
            got, aux_g = moe.moe_ffn(
                slot, x, num_experts=E, top_k=cfg.top_k,
                split=ModelSplit("cpu", mesh, ("data",)))
        assert len(seen) == 4
        for a, b in zip(seen[:2], seen[2:]):
            assert torch.equal(a, b)
        torch.testing.assert_close(got, want, **TOL)
        for k in aux_w:
            assert torch.equal(aux_g[k], aux_w[k])
        # the whole model on the mesh routes as the unsharded one
        batch = _batch(cfg)
        seen.clear()
        with torch.no_grad():
            transformer.forward_train(cfg, params, batch["tokens"],
                                      chunk_q=8, device="cpu")
            n = len(seen)
            transformer.forward_train(cfg, sp, batch["tokens"], chunk_q=8,
                                      shard_ctx={"mesh": mesh,
                                                 "dp": ("data",)})
        assert len(seen) == 2 * n
        for a, b in zip(seen[:n], seen[n:]):
            assert torch.equal(a, b)


def test_1x4_computes_each_kv_head_once_a_chip(monkeypatch):
    cfg = reduced(get_config("qwen2.5-32b"))     # H = 4, KV = 2, biases
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 2)
    model = Model(cfg)
    _, _, _, params = weights("qwen2.5-32b", seed=4)
    mesh, sp = _sharded(model, params, 1, 4)
    spy = _TakeSpy(monkeypatch)
    batch = _batch(cfg)
    with torch.no_grad():
        want, _ = transformer.forward_train(cfg, params, batch["tokens"],
                                            chunk_q=8, device="cpu")
        got, _ = transformer.forward_train(cfg, sp, batch["tokens"],
                                           chunk_q=8,
                                           shard_ctx={"mesh": mesh,
                                                      "dp": ("data",)})
    torch.testing.assert_close(got, want, **TOL)
    kv = [(leaf, m, out) for leaf, m, out in spy.calls
          if sharding.is_sharded(leaf) and tuple(leaf.shape)[1:] == (2, 16)
          and leaf.ndim == 3 and leaf.shape[0] == cfg.d_model]
    assert kv, "no wk/wv taken"
    for leaf, m, out in kv:
        # replicated over model (2 KV heads on 4 chips): one head a chip,
        # the one its query head m reads
        assert sharding.model_dim(leaf.placement, 3) is None
        assert out.shape[1] == 1
        full = sharding.gather(leaf, "cpu")
        assert torch.equal(out, full[:, m // 2:m // 2 + 1])


def test_a_vocabulary_that_does_not_divide_is_computed_once():
    cfg = dataclasses.replace(reduced(get_config("qwen3-14b")),
                              vocab_size=255)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(6), device="cpu")
    mesh, sp = _sharded(model, params, 1, 2)
    assert sharding.model_dim(sp["embed"].placement, 2) is None
    assert sharding.model_dim(sp["lm_head"].placement, 2) is None
    batch = _batch(cfg)
    ctx = {"mesh": mesh, "dp": ("data",)}
    with torch.no_grad():
        shards, starts, _ = transformer.forward_train_parts(
            cfg, sp, batch["tokens"], chunk_q=8, shard_ctx=ctx)
        want, _ = transformer.forward_train(cfg, params, batch["tokens"],
                                            chunk_q=8, device="cpu")
        lg, _ = model.loss_fn(sp, batch, chunk_q=8, shard_ctx=ctx)
        lw, _ = model.loss_fn(params, batch, chunk_q=8, device="cpu")
    assert len(shards) == 1 and starts == [0]
    torch.testing.assert_close(shards[0], want, **TOL)
    np.testing.assert_allclose(float(lg), float(lw), **TOL)
    # a vocabulary that divides is split: one shard a chip
    cfg2 = reduced(get_config("qwen3-14b"))
    model2 = Model(cfg2)
    p2 = model2.init(torch.Generator().manual_seed(6), device="cpu")
    mesh2, sp2 = _sharded(model2, p2, 1, 2)
    with torch.no_grad():
        shards, starts, _ = transformer.forward_train_parts(
            cfg2, sp2, batch["tokens"], chunk_q=8,
            shard_ctx={"mesh": mesh2, "dp": ("data",)})
    assert [s.shape[-1] for s in shards] == [128, 128] and starts == [0, 128]


def _slot(arch, kind, seed):
    _, cfg, _, params = weights(arch, seed=seed)
    model = Model(cfg)
    mesh, sp = _sharded(model, params, 1, 2)
    i = cfg.pattern.index(kind)
    return (cfg, mesh, transformer._at(params["period"], 0)[f"slot{i}"][kind],
            transformer._at(sp["period"], 0)[f"slot{i}"][kind])


def test_mamba_takes_its_x_and_z_slices(monkeypatch):
    cfg, mesh, plain, sharded_p = _slot("jamba-1.5-large-398b", "mamba", 7)
    Di = cfg.mamba_d_inner
    spy = _TakeSpy(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    want = mamba.mamba_block(plain, x, state_dim=cfg.mamba_state,
                             conv_width=cfg.mamba_conv, chunk=8)
    got = mamba.mamba_block(sharded_p, x, state_dim=cfg.mamba_state,
                            conv_width=cfg.mamba_conv, chunk=8,
                            split=ModelSplit("cpu", mesh, ("data",)))
    torch.testing.assert_close(got, want, **TOL)
    gw, = torch.autograd.grad(want.square().sum(), x)
    gg, = torch.autograd.grad(got.square().sum(), x)
    torch.testing.assert_close(gg, gw, **TOL)
    whole = plain["in_proj"]
    ins = [(m, out) for leaf, m, out in spy.calls
           if leaf is sharded_p["in_proj"]]
    assert [m for m, _ in ins] == [0, 1]
    half = Di // 2
    for m, out in ins:
        # the chip's x channels, then its z channels: not half of the
        # concatenation, whose block 0 is all of x and block 1 all of z
        lo = m * half
        assert torch.equal(out, torch.cat(
            [whole[:, lo:lo + half], whole[:, Di + lo:Di + lo + half]], 1))


def test_rwkv_gates_the_summed_channel_mix():
    cfg, mesh, plain, sharded_p = _slot("rwkv6-1.6b", "rwkv", 8)
    split = ModelSplit("cpu", mesh, ("data",), tally=SplitTally(mesh))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = rwkv6.channel_mix(plain["cm"], x)
        got = rwkv6.channel_mix(sharded_p["cm"], x, split=split)
        # one model-axis sum (w_v's partials) before the gate
        assert split.tally.sums == 1
        torch.testing.assert_close(got, want, **TOL)
        want = rwkv6.rwkv_block(plain, x, num_heads=cfg.num_heads,
                                head_dim=cfg.head_dim, chunk=8)
        got = rwkv6.rwkv_block(sharded_p, x, num_heads=cfg.num_heads,
                               head_dim=cfg.head_dim, chunk=8, split=split)
        torch.testing.assert_close(got, want, **TOL)
    with pytest.raises(ValueError, match="no recurrent state"):
        rwkv6.rwkv_block(sharded_p, x, num_heads=cfg.num_heads,
                         head_dim=cfg.head_dim, return_state=True,
                         split=split)


def test_gather_slice_is_indexing_and_carries_gradients():
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    full = torch.arange(4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6)
    cases = (((), [(1, 3), (0, 8), (2, 5)]),
             ((None, "model", "data"), [(0, 4), (2, 7), (0, 6)]),
             (("data", "model"), [(1, 4), (3, 5), (1, 2)]),
             (("model", None, "data"), [(0, 2), (0, 8), (0, 6)]))
    for spec, index in cases:
        st = sharding.shard(full, sharding.Placement(mesh, spec))
        blocks = [b.requires_grad_(True) for b in st.blocks]
        st = sharding.ShardedTensor(st.placement, st.shape, tuple(blocks))
        got = sharding.gather_slice(st, index, "cpu")
        want = full[tuple(slice(a, b) for a, b in index)]
        assert torch.equal(got, want)
        g = torch.autograd.grad((got * want).sum(), blocks,
                                allow_unused=True)
        g = [torch.zeros_like(b) if d is None else d
             for b, d in zip(blocks, g)]
        back = sharding.gather(sharding.ShardedTensor(st.placement,
                                                      st.shape, g), "cpu")
        mask = torch.zeros_like(full)
        mask[tuple(slice(a, b) for a, b in index)] = 1
        assert torch.equal(back, full * mask)
    # a model coordinate's own part, gathered over the data axis only
    st = sharding.shard(full, sharding.Placement(mesh, ("data", "model")))
    assert sharding.owned_range(st.placement, full.shape, 1) == \
        ((0, 4), (4, 8), (0, 6))
    assert torch.equal(sharding.gather_slice(
        st, sharding.owned_range(st.placement, full.shape, 1), "cpu"),
        full[:, 4:])
    # a replicated leaf on its own device comes back as its block
    rep = sharding.shard(full, sharding.Placement(mesh, ()))
    whole = sharding.gather_slice(rep, [(0, 4), (0, 8), (0, 6)], "cpu")
    assert whole.data_ptr() == rep.blocks[0].data_ptr()
    with pytest.raises(ValueError, match="one dim"):
        sharding.model_dim(sharding.Placement(mesh, ((("data", "model")),)),
                           3)


def test_vocab_parallel_cross_entropy_is_the_whole_one():
    rng = np.random.default_rng(9)
    logits = torch.from_numpy((rng.standard_normal((2, 5, 96)) * 3)
                              .astype(np.float32)).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, 96, (2, 5)))
    mask = torch.from_numpy((rng.random((2, 5)) > 0.3).astype(np.float32))
    for cut in ((0, 96), (0, 40, 96), (0, 32, 64, 96)):
        shards = [logits[..., a:b] for a, b in zip(cut, cut[1:])]
        for m in (None, mask):
            got = model_mod.vocab_parallel_cross_entropy(
                shards, list(cut[:-1]), labels, m, device="cpu")
            want = model_mod.cross_entropy_loss(logits, labels, m)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            gg, = torch.autograd.grad(got, logits)
            gw, = torch.autograd.grad(want, logits)
            torch.testing.assert_close(gg, gw, rtol=1e-6, atol=1e-7)
    # the target logit comes from the one chip holding it
    shards = [logits[..., :50].detach(), logits[..., 50:].detach()]
    tgt = collectives.vocab_target(shards, [0, 50], labels, "cpu")
    assert torch.equal(tgt, torch.gather(logits.detach(), -1,
                                         labels[..., None])[..., 0])
    parts = [torch.full((3,), float(i + 1)) for i in range(3)]
    assert torch.equal(collectives.model_sum(parts, "cpu"),
                       torch.full((3,), 6.0))


def test_gqa_heads_that_straddle_kv_groups():
    # 12 query heads on 3 KV heads (groups of 4) over tp = 2: chip 0's
    # heads 0-5 read KV heads 0,0,0,0,1,1, which no equal grouping
    # pairs, so the chip expands its two KV heads to one a query head
    from repro_torch.distributed.model_split import kv_heads
    assert kv_heads(0, 6, 4) == ((0, 2), [0, 0, 0, 0, 1, 1])
    assert kv_heads(6, 12, 4) == ((1, 3), [0, 0, 1, 1, 1, 1])
    assert kv_heads(0, 4, 2) == ((0, 2), None)
    assert kv_heads(3, 4, 2) == ((1, 2), None)
    from repro_torch.models import layers
    rng = np.random.default_rng(10)
    D, H, KV, hd = 32, 12, 3, 8

    def w(*shape, scale=0.2):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    p = {"ln": 1 + w(D), "wq": w(D, H, hd), "wk": w(D, KV, hd),
         "wv": w(D, KV, hd), "wo": w(H, hd, D), "bq": w(H, hd),
         "bk": w(KV, hd), "bv": w(KV, hd), "q_norm": 1 + w(hd),
         "k_norm": 1 + w(hd)}
    mesh = make_host_mesh(data=1, model=2, device="cpu")
    sp = sharding.shard_tree(p, sharding.param_shardings(p, mesh))
    assert sharding.model_dim(sp["wk"].placement, 3) is None
    assert sharding.model_dim(sp["wq"].placement, 3) == 1
    x = w(2, 16, D, scale=1.0)
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    kw = dict(positions=pos, head_dim=hd, num_heads=H, num_kv_heads=KV,
              rope_theta=1e4, qk_norm=True, chunk_q=8)
    with torch.no_grad():
        want = layers.self_attention_layer(p, x, **kw)
        got = layers.self_attention_layer(
            sp, x, split=ModelSplit("cpu", mesh, ("data",)), **kw)
    torch.testing.assert_close(got, want, **TOL)
    # a decode cache holds every KV head; a chip computes only its own
    with pytest.raises(ValueError, match="no decode cache"):
        layers.self_attention_layer(
            sp, x, split=ModelSplit("cpu", mesh, ("data",)),
            kv_override=lambda k, v: (k, v, pos), **kw)
