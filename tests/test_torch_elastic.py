"""Elastic re-meshing, mesh-portable checkpoints, the sharded training
driver and the int8 wire all-reduce (``repro_torch.ft.elastic``,
``repro_torch.ft.checkpoint``, ``repro_torch.launch.train``,
``repro_torch.distributed.collectives.compressed_psum``), on CPU chips.

- ``plan_remesh`` equals the reference's over a sweep of (available
  devices, TP) and a hypothesis property; ``build_mesh`` takes the
  plan's shape over the first devices given.
- ``remesh_state`` round trips bit for bit between meshes.
- A checkpoint saved sharded is the whole tree on disk: it restores on
  a (1, 1) mesh and unsharded exactly, and the reference restores it.
- ``run_training`` on a (2, 2) mesh, stopped at step 2 and resumed on
  (2, 2): the losses and final params are the uninterrupted run's bit
  for bit.  Resumed on a (2, 1) mesh: the data grouping is unchanged,
  but the model axis no longer splits heads, ``d_ff`` and vocabulary,
  so the partial sums' order changes: the losses within rtol = atol =
  1e-5 of the uninterrupted run's, and the final params by
  ``test_torch_mesh_step_ref.py``'s rule over the two steps run apart
  (within 1e-5 where the clipped gradient of the uninterrupted run's
  last step |g'| >= 10 eps, within 2 lr a step elsewhere).
- ``compressed_psum`` over four CPU chips: each participant's int8
  payload and float32 scale are the reference's ``_quantize``'s exactly,
  and the sum is within the reference test's bound, C · scale · 0.51.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as ref_collectives
from repro.ft import checkpoint as ref_ckpt
from repro.ft import elastic as ref_elastic
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import collectives, sharding
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft import elastic
from repro_torch.ft.watchdog import Watchdog
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)


def _plans_equal(n, tp):
    try:
        want = ref_elastic.plan_remesh(n, model_parallel=tp)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match="cannot keep TP"):
            elastic.plan_remesh(n, model_parallel=tp)
        return str(e)
    got = elastic.plan_remesh(n, model_parallel=tp)
    assert (got.mesh_shape, got.axis_names, got.dropped_devices) == \
        (tuple(want.mesh_shape), tuple(want.axis_names),
         want.dropped_devices)
    return got


def test_plan_remesh_matches_reference_over_a_sweep():
    for n in range(1, 70):
        for tp in (1, 2, 3, 4, 8, 16):
            _plans_equal(n, tp)
    plan = elastic.plan_remesh(7, model_parallel=2)
    mesh = elastic.build_mesh(plan, devices=["cpu"] * 7)
    assert mesh.shape == (2, 2) and mesh.size == 4
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 4 devices"):
        elastic.build_mesh(plan, devices=["cpu"] * 3)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 4096), st.integers(1, 64))
def test_plan_remesh_property(n, tp):
    got = _plans_equal(n, tp)
    if isinstance(got, str):
        assert n < tp
        return
    d, m = got.mesh_shape
    assert m == tp and d & (d - 1) == 0 and d * tp <= n < 2 * d * tp
    assert got.dropped_devices == n - d * tp


def _model_state(arch="mixtral-8x7b", seed=0):
    cfg = reduced(get_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    return model, params


def test_remesh_state_round_trips_bit_for_bit():
    model, params = _model_state()
    meshes = [make_host_mesh(data=d, model=m, device="cpu")
              for d, m in ((2, 2), (4, 1), (1, 1), (1, 4))]
    place = [sharding.param_shardings(model.param_shapes(), m)
             for m in meshes]
    state = sharding.shard_tree(params, place[0])
    for p in place[1:] + place[:1]:
        state = elastic.remesh_state(state, p)
        for leaf, want in zip(tree_leaves(state, sharding.is_sharded),
                              tree_leaves(p)):
            assert leaf.placement == want
        for a, b in zip(tree_leaves(sharding.gather_tree(state, "cpu")),
                        tree_leaves(params)):
            assert torch.equal(a, b)


def test_sharded_checkpoint_restores_anywhere_and_in_the_reference(tmp_path):
    model, params = _model_state(seed=2)
    opt = AdamW()
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    p_shard = sharding.param_shardings(model.param_shapes(), mesh)
    sp = sharding.shard_tree(params, p_shard)
    state = opt.init(sp)
    ckpt.save_checkpoint(tmp_path / "p", 4, sp)
    ckpt.save_checkpoint(tmp_path / "o", 4, state)
    # the files are the unsharded tree's
    ckpt.save_checkpoint(tmp_path / "u", 4, params)
    for name in ("manifest.json",):
        assert (tmp_path / "p" / "step_00000004" / name).read_text() == \
            (tmp_path / "u" / "step_00000004" / name).read_text()
    one = make_host_mesh(device="cpu")
    got = ckpt.restore_checkpoint(
        tmp_path / "p", model.param_shapes(),
        shardings=sharding.param_shardings(model.param_shapes(), one))
    for a, b in zip(tree_leaves(sharding.gather_tree(got, "cpu")),
                    tree_leaves(params)):
        assert torch.equal(a, b)
    plain = ckpt.restore_checkpoint(tmp_path / "p", params, device="cpu")
    for a, b in zip(tree_leaves(plain), tree_leaves(params)):
        assert torch.equal(a, b)
    # restoring into a sharded tree of another mesh, count kept plain
    o_shard = sharding.param_shardings(opt.init(model.param_shapes()),
                                       one)._replace(count=None)
    got_o = ckpt.restore_checkpoint(tmp_path / "o", state, shardings=o_shard,
                                    device="cpu")
    assert isinstance(got_o.count, torch.Tensor)
    assert all(leaf.placement.mesh == one for leaf in
               tree_leaves(got_o.mu, sharding.is_sharded))
    # the reference reads the sharded save, and its save restores sharded
    like = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), params)
    ref = ref_ckpt.restore_checkpoint(tmp_path / "p", like)
    for a, b in zip(tree_leaves(params), jax.tree.leaves(ref)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    ref_ckpt.save_checkpoint(tmp_path / "r", 5, ref)
    got = ckpt.restore_checkpoint(tmp_path / "r", model.param_shapes(),
                                  shardings=p_shard)
    for a, b in zip(tree_leaves(sharding.gather_tree(got, "cpu")),
                    tree_leaves(params)):
        assert torch.equal(a, b)


def _run(**kw):
    cfg = reduced(get_config("longformer-1.4b"))
    kw = {"steps": 4, "global_batch": 2, "seq_len": 16, "log_every": 100,
          "device": "cpu", "watchdog": Watchdog(clock=lambda: 0.0), **kw}
    return train.run_training(cfg, **kw)


class _LastStep:
    """Keeps the gradients and grad norm of the last step that
    ``run_training`` takes while it is active."""

    def __init__(self, monkeypatch):
        make = train.make_train_step

        def kept(*args, **kw):
            step = make(*args, grad_transform=self.keep, **kw)

            def run(params, state, batch):
                params, state, metrics = step(params, state, batch)
                self.grad_norm = float(metrics["grad_norm"])
                return params, state, metrics
            return run
        monkeypatch.setattr(train, "make_train_step", kept)

    def keep(self, grads):
        self.grads = grads
        return grads


def test_run_training_stops_on_2x2_and_resumes_on_2x1(tmp_path,
                                                        monkeypatch):
    last = _LastStep(monkeypatch)
    full_p, full = _run(data_parallel=2, model_parallel=2)
    grads = tree_leaves(sharding.gather_tree(last.grads, "cpu"))
    scale = min(1.0, 1.0 / (last.grad_norm + 1e-9))
    _, first = _run(data_parallel=2, model_parallel=2, stop_at=2,
                    ckpt_dir=tmp_path, ckpt_every=100)
    assert ckpt.latest_step(tmp_path) == 2
    res_p, rest = _run(data_parallel=2, model_parallel=1, ckpt_dir=tmp_path,
                       ckpt_every=100)
    assert first == full[:2]
    np.testing.assert_allclose(first + rest, full, rtol=1e-5, atol=1e-5)
    assert full[-1] < full[0]
    lr = 3e-4                        # run_training's peak learning rate
    for a, b, g in zip(tree_leaves(res_p), tree_leaves(full_p), grads):
        firm = g.abs() * scale >= 10 * 1e-8
        diff = (a - b).abs()
        assert bool((diff[firm] <= 1e-5 + 1e-5 * b.abs()[firm]).all())
        assert bool((diff[~firm] <= 2 * 2 * lr + 1e-5).all())
    # the CLI takes the mesh
    assert train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "4", "--seq", "16",
                       "--dp", "2", "--tp", "2"]) == 0


def test_run_training_stops_on_2x2_and_resumes_on_2x2(tmp_path):
    full_p, full = _run(data_parallel=2, model_parallel=2)
    _, first = _run(data_parallel=2, model_parallel=2, stop_at=2,
                    ckpt_dir=tmp_path, ckpt_every=100)
    res_p, rest = _run(data_parallel=2, model_parallel=2, ckpt_dir=tmp_path,
                       ckpt_every=100)
    assert first + rest == full
    for a, b in zip(tree_leaves(res_p), tree_leaves(full_p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", ((16, 32), (7,), (3, 4, 5)))
def test_compressed_psum_matches_the_reference_wire(shape):
    rng = np.random.default_rng(len(shape))
    mesh = make_host_mesh(data=4, model=1, device="cpu")
    parts = [(rng.standard_normal(shape) * (1 + c)).astype(np.float32)
             for c in range(4)]
    wire = collectives.int8_wire([torch.from_numpy(p) for p in parts])
    for (q, scale), p in zip(wire, parts):
        r_q, r_scale = ref_collectives._quantize(jnp.asarray(p))
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(r_q))
        assert scale.numpy().tobytes() == np.asarray(r_scale).tobytes()
    sums = collectives.compressed_psum([torch.from_numpy(p) for p in parts],
                                       mesh, axis="data")
    want = np.sum(parts, axis=0)
    bound = sum(float(np.abs(p).max()) / 127.0 for p in parts) * 0.51
    for s in sums:
        assert torch.equal(s, sums[0])
        assert float(np.abs(s.numpy() - want).max()) <= bound + 1e-6
    # the reference's own case: every participant contributes x
    x = parts[0]
    got = collectives.compressed_psum([torch.from_numpy(x)] * 4, mesh)[0]
    scale = float(np.abs(x).max()) / 127.0
    assert float(np.abs(got.numpy() - 4 * x).max()) <= 4 * scale * 0.51 \
        + 1e-6
    # on a (2, 2) mesh the sum runs within each model column
    mesh22 = make_host_mesh(data=2, model=2, device="cpu")
    sums = collectives.compressed_psum([torch.from_numpy(p) for p in parts],
                                       mesh22, axis="data")
    deq = [q.float() * s for q, s in wire]
    assert torch.equal(sums[0], deq[0] + deq[2])
    assert torch.equal(sums[3], deq[1] + deq[3])
    with pytest.raises(ValueError, match="no axis"):
        collectives.compressed_psum(parts, mesh, axis="pod")
