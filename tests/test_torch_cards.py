"""Meshes whose chips lie on several cards, checked without a card.

A ``torch.device("cuda", i)`` needs no card, and ``LogicalMesh``
normalises an indexed device without touching CUDA, so the layout of
``make_host_mesh(cards=)``, the devices the sharded step computes on,
its refusals, the tally's per-device spans and AdamW's grad norm over
blocks are all checked here on the CPU.  The step itself over four
cards runs only on a machine with four of them (the ``cuda`` test at
the end).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import model_split, sharding
from repro_torch.distributed.model_split import ModelSplit, SplitTally
from repro_torch.ft import elastic
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train import make_train_step
from repro_torch.train.train_step import data_groups

from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)


def _cards(n):
    return [torch.device("cuda", i) for i in range(n)]


def _mesh(cards=4, shape=(2, 2)):
    """A (data, model) mesh over ``cards`` CUDA cards, built without one."""
    n = shape[0] * shape[1]
    return sharding.LogicalMesh(("data", "model"), shape,
                                sharding.spread(_cards(cards), n))


# -- the layout ------------------------------------------------------------

@pytest.mark.parametrize("cards,want", (
    (1, (0, 0, 0, 0)),
    (2, (0, 0, 1, 1)),       # a data group a card, its model chips sharing
    (4, (0, 1, 2, 3)),       # a card a chip
))
def test_chips_lie_on_cards_in_contiguous_runs(cards, want):
    devs = sharding.spread(_cards(cards), 4)
    assert devs == tuple(torch.device("cuda", i) for i in want)
    mesh = _mesh(cards)
    # row-major: chip (d, m) is flat 2 d + m
    for chip, i in enumerate(want):
        assert mesh.coords(chip) == {"data": chip // 2, "model": chip % 2}
        assert mesh.devices[chip] == torch.device("cuda", i)


@pytest.mark.parametrize("cards", (0, 3, 8))
def test_cards_that_do_not_divide_the_chips_are_refused(cards):
    with pytest.raises(ValueError, match="do not divide"):
        sharding.spread(_cards(cards), 4)


def _visible(monkeypatch, count):
    """``count`` CUDA cards visible, whatever this machine has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


def test_make_host_mesh_refuses_what_it_cannot_lay_out(monkeypatch):
    _visible(monkeypatch, 2)
    with pytest.raises(ValueError, match="cards must be >= 1"):
        make_host_mesh(data=2, model=2, cards=0)
    with pytest.raises(ValueError, match="do not divide"):
        make_host_mesh(data=2, model=2, cards=3)
    with pytest.raises(ValueError, match="CUDA cards"):
        make_host_mesh(data=2, model=2, cards=2, device="cpu")
    # more cards than are visible: the reference's assert on too few
    # devices
    with pytest.raises(ValueError, match="visible"):
        make_host_mesh(data=2, model=2, cards=4)
    with pytest.raises(ValueError, match="visible"):
        make_host_mesh(data=2, model=2, cards=2, device="cuda:1")
    # one card: today's mesh, every chip on the device
    mesh = make_host_mesh(data=2, model=2, device="cpu", cards=1)
    assert mesh.devices == (torch.device("cpu"),) * 4


@pytest.mark.parametrize("device,want", (
    (None, (0, 0, 1, 1)),
    ("cuda", (0, 0, 1, 1)),
    ("cuda:0", (0, 0, 1, 1)),
    ("cuda:2", (2, 2, 3, 3)),     # the cards from the device's on
))
def test_make_host_mesh_lays_chips_out_from_the_first_card(monkeypatch,
                                                           device, want):
    _visible(monkeypatch, 4)
    mesh = make_host_mesh(data=2, model=2, device=device, cards=2)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in want)


@pytest.mark.parametrize("survivors", (2, 3))
def test_elastic_mesh_takes_the_surviving_cards(survivors):
    # one chip a surviving card, as the reference's mesh takes a device a
    # chip: (2, 1) over cuda:0..1 after losing the model axis's second card
    plan = elastic.plan_remesh(survivors, model_parallel=1)
    mesh = elastic.build_mesh(plan, devices=_cards(survivors))
    assert mesh.shape == (2, 1)
    assert mesh.devices == tuple(_cards(2))
    # a (2, 2) plan needs four; fewer survivors are refused
    with pytest.raises(ValueError, match="needs 4 devices"):
        elastic.build_mesh(elastic.plan_remesh(4, model_parallel=2),
                           devices=_cards(survivors - 1))


# -- where each group, chip and block lies ------------------------------------

@pytest.mark.parametrize("cards", (1, 2, 4))
def test_data_groups_and_model_chips_name_their_cards(cards):
    mesh = _mesh(cards)
    ctx = {"mesh": mesh, "dp": ("data",)}
    groups = data_groups(ctx, 4, device=None)
    assert [(g, dev, (r.start, r.stop)) for g, dev, r in groups] == [
        (0, str(mesh.devices[0]), (0, 2)), (1, str(mesh.devices[2]), (2, 4))]
    for g in range(2):
        split = ModelSplit(groups[g][1], mesh, ("data",), group=g)
        assert split.chips == (2 * g, 2 * g + 1)
        assert split.devices == tuple(str(mesh.devices[c])
                                      for c in split.chips)
        assert split.on(None) == groups[g][1]


@pytest.mark.parametrize("cards", (2, 4))
def test_each_block_lies_on_the_card_of_its_first_chip(cards):
    mesh = _mesh(cards)
    dev = mesh.devices
    cases = {
        ("data", "model"): (dev[0], dev[1], dev[2], dev[3]),
        (None, "model"): (dev[0], dev[1]),     # replicated over data
        ("data",): (dev[0], dev[2]),           # replicated over model
        (): (dev[0],),
    }
    for spec, want in cases.items():
        assert sharding.Placement(mesh, spec).block_devices(2) == want, spec
    # a period-stacked wq (P, D, H, hd): FSDP over data, heads over model
    stacked = sharding.Placement(mesh, (None, "data", "model"))
    assert stacked.block_devices(4) == cases[("data", "model")]


def test_the_step_builds_on_cards_and_refuses_mixed_types():
    model = Model(reduced(get_config("longformer-1.4b")))
    opt = AdamW()
    step = make_train_step(model, opt, shard_ctx={"mesh": _mesh(4),
                                                  "dp": ("data",)})
    assert callable(step)
    for devices in (("cpu", "meta"), ("cpu", "cuda:0"), ("meta", "meta"),
                    ("cuda:1", "meta")):
        mesh = sharding.LogicalMesh(("data", "model"), (2, 1), devices)
        with pytest.raises(ValueError, match="mixes device types"):
            make_train_step(model, opt, shard_ctx={"mesh": mesh,
                                                   "dp": ("data",)})


@pytest.mark.parametrize("shape,cards", (
    ((2, 2), 4),      # the last model chip of each group off its card
    ((2, 2), 2),      # each group's chips on its card
    ((4, 2), 4),
    ((4, 1), 4),
    ((1, 2), 2),
    ((1, 4), 4),      # model chips 1, 2 and 3 off the group's card
    ((1, 4), 2),      # model chips 2 and 3 off it
    ((2, 4), 4),
))
def test_every_layout_over_cards_builds(shape, cards):
    """Every chip reaches its inputs through a node of its own, so any
    model chip may lie off its group's card: each layout builds, its
    groups' model chips on the cards ``spread`` gives them."""
    model = Model(reduced(get_config("longformer-1.4b")))
    mesh = _mesh(cards, shape)
    ctx = {"mesh": mesh, "dp": ("data",)}
    assert callable(make_train_step(model, AdamW(), shard_ctx=ctx))
    for g in range(shape[0]):
        split = ModelSplit(None, mesh, ("data",), group=g)
        assert split.devices == tuple(
            str(mesh.devices[g * shape[1] + m]) for m in range(shape[1]))


# -- the tally on several cards ----------------------------------------------

class _At:
    """A stand-in for a CUDA event on ``device`` at time ``at`` ms."""

    def __init__(self, device, at):
        self.device, self.at = torch.device(device), float(at)

    def elapsed_time(self, later):
        return later.at - self.at


def _one_stream_ms(timeline, n):
    """The one-device pairing: every event with the next, a span from a
    start forward, one from a chip's back mark to its next grad mark
    backward."""
    fwd, bwd = [0.0] * n, [0.0] * n
    owner = None
    for (kind, chip, a), (_, _, b) in zip(timeline, timeline[1:]):
        if kind == "back":
            owner = chip
        elif kind == "grad":
            owner = None
        if kind == "start":
            fwd[chip] += a.elapsed_time(b)
        elif owner is not None:
            bwd[owner] += a.elapsed_time(b)
    return fwd, bwd


def _timeline(tally):
    c0, c1 = "cuda:0", "cuda:1"
    tally.timeline += [
        ("start", 0, _At(c0, 0)), ("end", 0, _At(c0, 5)),
        ("start", 1, _At(c1, 1)), ("end", 1, _At(c1, 8)),
        ("back", 1, _At(c1, 10)), ("grad", 1, _At(c1, 12)),
        ("grad", 1, _At(c1, 13)),
        ("back", 0, _At(c0, 14)), ("grad", 0, _At(c0, 20)),
        ("grad", None, _At(c0, 21)),
        ("start", 0, _At(c0, 30)), ("grad", 0, _At(c0, 31)),
    ]
    tally.sum_spans.append((_At(c0, 21), _At(c0, 23)))


def test_the_tally_pairs_events_within_a_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    mesh = _mesh(4)
    tally = SplitTally(mesh, timed=True)
    _timeline(tally)
    fwd, bwd = tally.chip_ms()
    # chip 1's part is 1 -> 8 on its card, not 1 -> chip 0's next event
    assert fwd == [5.0 + 1.0, 7.0, 0.0, 0.0]
    # a chip's backward runs from its back mark to its card's next grad
    # mark; a take's or a sum's mark ends it
    assert bwd == [6.0, 2.0, 0.0, 0.0]
    assert tally.sum_ms() == 2.0
    assert tally.card_ms() == {torch.device("cuda", i): ms for i, ms in
                               enumerate((5 + 1 + 6 + 2, 7 + 2, 0, 0))}
    # every card of the mesh synchronised, each once a read
    assert synced[:4] == list(mesh.devices)


def test_the_tally_puts_every_card_on_one_clock(monkeypatch):
    """``intervals`` measures each span from its card's zero event, so
    spans on two cards compare: the chips' overlap is the time both run."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(model_split, "_event", lambda d: _At(d, 0))
    tally = SplitTally(_mesh(4), timed=True)
    tally.begin()
    assert set(tally.zero) == set(_cards(4))
    tally.zero[torch.device("cuda", 1)] = _At("cuda:1", -100)
    _timeline(tally)
    assert tally.intervals([0], "backward") == [(14.0, 20.0)]
    assert tally.intervals([1], "backward") == [(110.0, 112.0)]
    zero = _At("cuda:1", 0)
    tally.zero[torch.device("cuda", 1)] = zero
    a, b = tally.intervals([0]), tally.intervals([1])
    assert a == [(0.0, 5.0), (14.0, 20.0), (30.0, 31.0)]
    assert b == [(1.0, 8.0), (10.0, 12.0)]
    assert model_split.overlap(a, b) == 4.0 == model_split.overlap(b, a)
    assert model_split.busy(a) == 12.0
    # spans that meet merge
    assert tally.intervals() == [(0.0, 8.0), (10.0, 12.0), (14.0, 20.0),
                                 (30.0, 31.0)]


def test_on_one_card_the_tally_is_the_one_stream_pairing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rng = np.random.default_rng(0)
    mesh = _mesh(1)
    tally = SplitTally(mesh, timed=True)
    t = 0.0
    for _ in range(200):
        kind = rng.choice(["start", "end", "back", "grad"])
        chip = None if kind == "grad" and rng.random() < 0.2 else \
            int(rng.integers(4))
        t += float(rng.integers(1, 9))
        tally.timeline.append((str(kind), chip, _At("cuda:0", t)))
    fwd, bwd = tally.chip_ms()
    assert (fwd, bwd) == _one_stream_ms(tally.timeline, 4)
    assert sum(bwd) > 0


def test_a_timed_step_records_each_event_on_its_chips_device(monkeypatch):
    """Under the real step (CPU chips), every start/end event names the
    chip's device and every grad mark the gradient's."""
    seen = []

    class Tick(_At):
        clock = 0

        def __init__(self, device):
            Tick.clock += 1
            super().__init__(device, Tick.clock)
            seen.append(self.device)

    monkeypatch.setattr(model_split, "_event", Tick)
    cfg = reduced(get_config("longformer-1.4b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    sp = sharding.shard_tree(params, sharding.param_shardings(
        model.param_shapes(), mesh))
    tok = torch.randint(0, cfg.vocab_size, (2, 17),
                        generator=torch.Generator().manual_seed(1))
    tally = SplitTally(mesh, timed=True)
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(model, opt, chunk_q=8, shard_ctx={
        "mesh": mesh, "dp": ("data",), "tally": tally})
    step(sp, opt.init(sp), {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    assert seen and set(seen) == {torch.device("cpu")}
    fwd, bwd = tally.chip_ms()
    assert all(v > 0 for v in fwd) and all(v > 0 for v in bwd)
    assert sum(tally.card_ms().values()) >= sum(fwd) + sum(bwd)


# -- the backward's order, which makes four cards one card ---------------------

def _chips_grad(n, copied):
    """The gradient of ``x`` through ``h = 3 x`` taken by ``n`` chips,
    two uses each; the chips in ``copied`` reach ``h`` through a copy
    (the card-to-card ``.to``), the rest read it where it lies."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(48, 32, generator=gen).requires_grad_(True)
    ws = [torch.randn(32, 32, generator=gen) * 10.0 ** (2 * k - 3)
          for k in range(2 * n)]
    g = torch.randn(48, 32, generator=gen)
    with torch.autograd.set_multithreading_enabled(False):
        h = x * 3.0
        parts = []
        for m in range(n):
            hm = h.clone() if m in copied else h
            parts.append(hm @ ws[2 * m] + hm @ ws[2 * m + 1])
        loss = (sum(parts) * g).sum()
        return torch.autograd.grad(loss, x)[0]


def test_a_copied_second_chip_adds_first_as_one_sum():
    """On one device the second chip's contributions to ``h``'s gradient
    add first; reaching ``h`` through a copy, they arrive as their sum,
    first, which is the same arithmetic.  A copied FIRST chip instead
    adds its sum last, which shows the order is what is checked."""
    direct = _chips_grad(2, copied=())
    assert torch.equal(_chips_grad(2, copied=(1,)), direct)
    assert not torch.equal(_chips_grad(2, copied=(0,)), direct)


@pytest.mark.parametrize("copied,same", (
    ((2,), True),            # the last chip: its sum is the first arrival
    ((1, 2), False),         # (1, 4) over four cards, in three chips
    ((1,), False),
))
def test_with_three_chips_only_the_last_may_be_copied(copied, same):
    """A copied middle chip's sum adds to the later chips' as one term,
    where on one device its parts add one by one: why every chip reaches
    its inputs through a node of its own (below)."""
    direct = _chips_grad(3, copied=())
    assert torch.equal(_chips_grad(3, copied=copied), direct) == same


def _chips_grad_ahead(n, copied):
    """``_chips_grad`` as the split runs it: every chip takes ``h``
    through a node of its own before the first part, a copy for the
    chips in ``copied`` (``_CardCopy``, the copy between cards) and a
    view for the rest (``model_split.reach`` on its own device)."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(48, 32, generator=gen).requires_grad_(True)
    ws = [torch.randn(32, 32, generator=gen) * 10.0 ** (2 * k - 3)
          for k in range(2 * n)]
    g = torch.randn(48, 32, generator=gen)
    with torch.autograd.set_multithreading_enabled(False):
        h = x * 3.0
        taken = [sharding._CardCopy.apply(h, h.device, None) if m in copied
                 else model_split.reach(h, h.device) for m in range(n)]
        parts = [hm @ ws[2 * m] + hm @ ws[2 * m + 1]
                 for m, hm in enumerate(taken)]
        loss = (sum(parts) * g).sum()
        return torch.autograd.grad(loss, x)[0]


def _subsets(n):
    return [tuple(m for m in range(n) if bits >> m & 1)
            for bits in range(2 ** n)]


@pytest.mark.parametrize("n,copied", [(n, c) for n in (2, 3, 4)
                                      for c in _subsets(n)])
def test_any_set_of_copied_chips_gives_the_one_device_gradient(n, copied):
    """With a node a chip, taken ahead, each chip's gradient arrives as
    one term whether its node is a copy or a view: four cards are one
    card bit for bit whichever chips lie off the group's card."""
    ones = _chips_grad_ahead(n, copied=())
    assert torch.equal(_chips_grad_ahead(n, copied=copied), ones)


# -- the backward reaches every chip's part before any take --------------------

class _Blocks:
    """Records every ``ModelSplit.run`` of a forward: its kind (the
    block's function), each chip's taken tensors and part outputs."""

    def __init__(self, monkeypatch):
        self.blocks = []
        run = ModelSplit.run

        def spied(split, chips, take, part):
            rec = {"kind": take.__qualname__.split(".")[0] + "."
                   + take.__name__, "takes": [], "parts": []}
            self.blocks.append(rec)

            def took(m):
                out = take(m)
                rec["takes"].append([t for t in out if isinstance(
                    t, torch.Tensor) and t.grad_fn is not None])
                return out

            outs = run(split, chips, took, part)
            for o in outs:
                rec["parts"].append([t for t in (o if isinstance(o, tuple)
                                                 else (o,))
                                     if t.grad_fn is not None])
            return outs
        monkeypatch.setattr(ModelSplit, "run", spied)


def _nodes_after(roots, floor):
    """The autograd nodes reachable from ``roots`` made after sequence
    number ``floor``."""
    seen, todo = {}, list(roots)
    while todo:
        node = todo.pop()
        if node is None or node._sequence_nr() <= floor or node in seen:
            continue
        seen[node] = None
        todo += [nxt for nxt, _ in node.next_functions]
    return list(seen)


ORDER_ARCHS = {
    "longformer-1.4b": {"sparse_self_attention_layer.take",
                        "swiglu_mlp.take", "_head_parts.take"},
    "mixtral-8x7b": {"self_attention_layer.take", "moe_ffn.take"},
    "jamba-1.5-large-398b": {"mamba_block.take_in", "mamba_block.take_scan"},
    "rwkv6-1.6b": {"time_mix.take", "channel_mix.take_k",
                   "channel_mix.take_r"},
    "llama-3.2-vision-11b": {"cross_attention_layer.take"},
}


@pytest.mark.parametrize("arch", sorted(ORDER_ARCHS))
def test_the_backward_runs_every_chips_part_before_any_take(arch,
                                                            monkeypatch):
    """On (1, 4) at ``reduced()``, for every split block kind: hooks on
    the autograd nodes show the backward running each chip's part whole
    before the first take's node (a copy back to the group's card on
    four cards), so no card waits for another's part."""
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    mesh = make_host_mesh(data=1, model=4, device="cpu")
    sp = sharding.shard_tree(params, sharding.param_shardings(
        model.param_shapes(), mesh))
    batch = _order_batch(cfg)
    rec = _Blocks(monkeypatch)
    log = []
    real_grad = torch.autograd.grad

    def grad(loss, *args, **kw):
        for i, b in enumerate(rec.blocks):
            takes = [t.grad_fn for ts in b["takes"] for t in ts]
            for m, (ts, outs) in enumerate(zip(b["takes"], b["parts"])):
                # chip m's part: the nodes made after its own takes
                floor = max(t.grad_fn._sequence_nr() for t in ts)
                for node in _nodes_after([t.grad_fn for t in outs], floor):
                    node.register_prehook(
                        lambda g, i=i, m=m: log.append(("part", i, m)))
            for node in takes:
                node.register_prehook(
                    lambda g, i=i: log.append(("take", i, None)))
        return real_grad(loss, *args, **kw)

    monkeypatch.setattr(torch.autograd, "grad", grad)
    opt = AdamW(learning_rate=1e-3)
    step = make_train_step(model, opt, chunk_q=8, remat="none",
                           shard_ctx={"mesh": mesh, "dp": ("data",)})
    step(sp, opt.init(sp), batch)
    kinds = set()
    for i, b in enumerate(rec.blocks):
        events = [(n, kind, m) for n, (kind, j, m) in enumerate(log)
                  if j == i]
        parts = [n for n, kind, _ in events if kind == "part"]
        takes = [n for n, kind, _ in events if kind == "take"]
        assert parts and takes, (b["kind"], events[:4])
        assert max(parts) < min(takes), b["kind"]
        if len(b["parts"]) == 4:
            kinds.add(b["kind"])
            # and each chip's part whole before the next's: chip 3 first
            chips = [m for _, kind, m in events if kind == "part"]
            assert chips == sorted(chips, reverse=True), b["kind"]
    assert ORDER_ARCHS[arch] <= kinds, kinds


def _order_batch(cfg):
    tok = torch.randint(0, cfg.vocab_size, (2, 17),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.num_image_tokens:
        batch["image_embeds"] = torch.randn(
            2, cfg.num_image_tokens, cfg.d_model,
            generator=torch.Generator().manual_seed(2))
    return batch


# -- forced copies: the steps a card crossing gives ---------------------------

def _forced_copy(t, device, ready=None):
    """``sharding.card_copy`` with every move a copy, as if each chip lay
    on a card of its own."""
    return sharding._CardCopy.apply(t, torch.device(device), ready)


@pytest.mark.parametrize("shape", ((1, 4), (2, 4)))
@pytest.mark.parametrize("arch", ("longformer-1.4b", "mixtral-8x7b"))
def test_steps_with_copies_are_the_steps_with_views(arch, shape,
                                                    monkeypatch):
    """The reduced step with every take and gather a copy (standing in
    for each chip on a card of its own) is ``torch.equal`` to the same
    step with views: loss, grad norm, parameters and both moments."""
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    mesh = make_host_mesh(data=shape[0], model=shape[1], device="cpu")
    sp = sharding.shard_tree(params, sharding.param_shardings(
        model.param_shapes(), mesh))
    batch = _order_batch(cfg)
    opt = AdamW(learning_rate=1e-3)
    outs = []
    for forced in (False, True):
        copies = []
        if forced:
            def counted(t, device, ready=None):
                copies.append(1)
                return _forced_copy(t, device, ready)
            monkeypatch.setattr(sharding, "card_copy", counted)
        step = make_train_step(model, opt, chunk_q=8, shard_ctx={
            "mesh": mesh, "dp": ("data",)})
        outs.append(step(sp, opt.init(sp), batch))
        assert bool(copies) == forced
    (p0, s0, m0), (p1, s1, m1) = outs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(tree_leaves((p0, s0.mu, s0.nu)),
                    tree_leaves((p1, s1.mu, s1.nu))):
        assert torch.equal(a, b)


# -- AdamW over blocks ---------------------------------------------------------

def _old_update(opt, grads, state, params):
    """The update before blocks could lie on several cards."""
    grads = tree_map(lambda g: g.float(), grads)
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g))
    gnorm = torch.sqrt(total)
    scale = torch.clamp(opt.clip_norm / (gnorm + 1e-9), max=1.0)
    grads = tree_map(lambda g: g * scale, grads)
    count = state.count + 1
    b1, b2 = opt.b1, opt.b2
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    c = count.float()
    bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
    lr = opt._lr(count)
    upd = tree_map(lambda m, v, p: (-lr * ((m / bc1) / (
        torch.sqrt(v / bc2) + opt.eps) + opt.weight_decay * p.float()))
        .to(p.dtype), mu, nu, params)
    return upd, gnorm, mu, nu


@pytest.mark.parametrize("sharded", (False, True))
def test_adamw_over_blocks_is_the_one_device_sum(sharded):
    gen = torch.Generator().manual_seed(3)
    params = {f"w{i}": torch.randn(8, 4 * (i + 1), generator=gen)
              for i in range(5)}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 3.0,
                     params)
    if sharded:
        mesh = make_host_mesh(data=2, model=2, device="cpu")
        place = sharding.Placement(mesh, ("data", "model"))
        params = {k: sharding.shard(v, place) for k, v in params.items()}
        grads = {k: sharding.shard(v, place) for k, v in grads.items()}
    opt = AdamW(learning_rate=1e-2)
    state = opt.init(params)
    for _ in range(2):
        want_u, want_n, want_mu, want_nu = _old_update(opt, grads, state,
                                                        params)
        upd, state, gnorm = opt.update(grads, state, params)
        assert torch.equal(gnorm, want_n)
        for a, b in zip(tree_leaves((upd, state.mu, state.nu)),
                        tree_leaves((want_u, want_mu, want_nu))):
            assert torch.equal(a, b)
        params = AdamW.apply_updates(params, upd)


# -- on four cards -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((2, 2), (1, 4)))
def test_four_cards_step_is_the_one_card_step_bit_for_bit(shape):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cfg = reduced(get_config("longformer-1.4b"))
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda:0").manual_seed(0),
                        device="cuda:0")
    tok = torch.randint(2, cfg.vocab_size, (2, 65), device="cuda:0",
                        generator=torch.Generator(device="cuda:0")
                        .manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = AdamW(learning_rate=1e-3)
    results = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for cards in (4, 1):
            mesh = make_host_mesh(data=shape[0], model=shape[1],
                                  cards=cards)
            sp = sharding.shard_tree(params, sharding.param_shardings(
                model.param_shapes(), mesh))
            step = make_train_step(model, opt, chunk_q=16, shard_ctx={
                "mesh": mesh, "dp": ("data",)})
            sp, state, metrics = step(sp, opt.init(sp), batch)
            results.append(sharding.gather_tree(
                (sp, state.mu, state.nu, metrics), "cpu"))
    finally:
        torch.use_deterministic_algorithms(False)
    four, one = results
    for a, b in zip(tree_leaves(four), tree_leaves(one)):
        assert torch.equal(a, b)
