"""The port's token pipeline, checkpoints, watchdog, meshes and training
driver (``repro_torch.data.pipeline``, ``repro_torch.ft``,
``repro_torch.launch.{mesh,train}``), on the CPU.

``TokenPipeline`` gives the reference's batches exactly (both sources).
Checkpoints cross-load between the packages exactly, fp32, bf16 and
int32 leaves and an ``AdamWState`` included.  The watchdog runs the
reference's fake-clock cases.  ``run_training`` is held to itself, not
to the reference's loss curve (the packages draw different initial
weights, and the reference's driver fails under its host mesh on this
jax): a resume from a checkpoint equals the uninterrupted run bit for
bit, the loss falls, an injected straggler restores the last checkpoint
and a mesh with an empty axis raises.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.ft import checkpoint as ref_ckpt
from repro.ft.watchdog import Watchdog as RefWatchdog
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.ft import checkpoint as ckpt
from repro_torch.ft.watchdog import StepTimeout, Watchdog
from repro_torch.launch import mesh, train
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves, tree_unflatten


# -- the token pipeline ---------------------------------------------------------

@pytest.mark.parametrize("kw", (
    dict(vocab_size=128, seq_len=32, global_batch=8, seed=7),
    dict(vocab_size=50, seq_len=63, global_batch=3, seed=0,
         num_image_tokens=4, d_model=16),
))
def test_synthetic_batches_equal_the_reference(kw):
    got, want = TokenPipeline(PipelineConfig(**kw)), \
        RefTokenPipeline(RefPipelineConfig(**kw))
    for step in (0, 1, 5, 17, 1000):
        a, b = got.batch_at(step), want.batch_at(step)
        assert set(a) == set(b)
        for name in a:
            assert a[name].dtype == b[name].dtype
            assert np.array_equal(a[name], b[name]), (step, name)
    resumed = next(got.iter_from(5))
    assert np.array_equal(resumed["tokens"], want.batch_at(5)["tokens"])


def test_token_file_batches_equal_the_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(3).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(vocab_size=1000, seq_len=48, global_batch=4, seed=2,
              token_file=str(path))
    for host in (0, 1):
        got = TokenPipeline(PipelineConfig(**kw), host_index=host,
                            host_count=2)
        want = RefTokenPipeline(RefPipelineConfig(**kw), host_index=host,
                                host_count=2)
        for step in (0, 3, 9):
            a, b = got.batch_at(step), want.batch_at(step)
            for name in ("tokens", "labels"):
                assert np.array_equal(a[name], b[name])
    short = tmp_path / "short.bin"
    np.zeros(10, np.int32).tofile(short)
    with pytest.raises(ValueError, match="too short"):
        TokenPipeline(PipelineConfig(1000, 48, 4, token_file=str(short)))


# -- checkpoints ------------------------------------------------------------------

def _port_tree():
    rng = np.random.default_rng(0)
    params = {"embed": torch.from_numpy(rng.standard_normal((6, 4)).astype(
                  np.float32)),
              "period": {"slot0": {"w": torch.from_numpy(
                  rng.standard_normal((2, 3, 5)).astype(np.float32)
              ).to(torch.bfloat16)}},
              "final_norm": torch.arange(4, dtype=torch.float32)}
    state = AdamW().init(params)
    moments = [torch.from_numpy(rng.standard_normal(t.shape).astype(
        np.float32)) for t in tree_leaves((state.mu, state.nu))]
    n = len(moments) // 2
    state = type(state)(count=torch.tensor(7, dtype=torch.int32),
                        mu=tree_unflatten(state.mu, moments[:n]),
                        nu=tree_unflatten(state.nu, moments[n:]))
    return params, state


def _ref_like(tree):
    return jax.tree.map(lambda t: np.asarray(_as_np(t)), tree)


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def _ref_adamw_state(state):
    return ref_adamw.AdamWState(
        count=jnp.asarray(state.count.numpy()),
        mu=jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.mu),
        nu=jax.tree.map(lambda t: jnp.asarray(t.numpy()), state.nu))


def _same(port_leaves, ref_leaves):
    assert len(port_leaves) == len(ref_leaves)
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r)
        assert str(p.dtype).split(".")[-1] == str(r.dtype)
        assert tuple(p.shape) == r.shape
        assert _as_np(p).tobytes() == r.tobytes()


def test_port_checkpoints_restore_in_the_reference(tmp_path):
    params, state = _port_tree()
    ckpt.save_checkpoint(tmp_path / "p", 3, params)
    ckpt.save_checkpoint(tmp_path / "o", 3, state)
    got = ref_ckpt.restore_checkpoint(
        tmp_path / "p", jax.tree.map(jnp.asarray, _ref_like(params)))
    _same(tree_leaves(params), jax.tree.leaves(got))
    like = _ref_adamw_state(state)
    got = ref_ckpt.restore_checkpoint(tmp_path / "o", like)
    assert isinstance(got, ref_adamw.AdamWState)
    _same(tree_leaves(state), jax.tree.leaves(got))
    manifest = json.loads((tmp_path / "p" / "step_00000003" /
                           "manifest.json").read_text())
    assert [leaf["dtype"] for leaf in manifest["leaves"]] == \
        ["float32", "float32", "bfloat16"]


def test_reference_checkpoints_restore_in_the_port(tmp_path):
    params, state = _port_tree()
    ref_params = jax.tree.map(jnp.asarray, _ref_like(params))
    ref_ckpt.save_checkpoint(tmp_path / "p", 5, ref_params)
    ref_ckpt.save_checkpoint(tmp_path / "o", 5, _ref_adamw_state(state))
    meta = jax.tree.map(lambda t: t.to("meta"), params)
    got = ckpt.restore_checkpoint(tmp_path / "p", meta, device="cpu")
    assert set(got) == set(params) and got["period"]["slot0"]["w"].dtype \
        == torch.bfloat16
    _same(tree_leaves(got), jax.tree.leaves(ref_params))
    got = ckpt.restore_checkpoint(tmp_path / "o", state, device="cpu")
    assert type(got).__name__ == "AdamWState"
    assert got.count.dtype == torch.int32 and int(got.count) == 7
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert torch.equal(a, b)


def test_restore_checks_leaves_against_the_tree(tmp_path):
    params, _ = _port_tree()
    ckpt.save_checkpoint(tmp_path, 1, params)
    wrong = dict(params, final_norm=torch.zeros(5))
    with pytest.raises(ValueError, match="leaf"):
        ckpt.restore_checkpoint(tmp_path, wrong, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_checkpoint(tmp_path, {"x": torch.zeros(1)},
                                device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tmp_path / "none", params, device="cpu")


def test_checkpoint_keep_last_and_latest(tmp_path):
    tree = {"x": torch.zeros(3)}
    assert ckpt.latest_step(tmp_path / "none") is None
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, tree, keep_last=2)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_00000004", "step_00000005"]


def test_interrupted_save_leaves_the_last_checkpoint(tmp_path, monkeypatch):
    tree = {"x": torch.arange(3.0)}
    ckpt.save_checkpoint(tmp_path, 1, tree)

    def boom(*args, **kw):
        raise KeyboardInterrupt("killed mid-save")

    monkeypatch.setattr(ckpt.np, "savez", boom)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(tmp_path, 2, {"x": torch.ones(3)})
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001"]
    assert ckpt.latest_step(tmp_path) == 1
    got = ckpt.restore_checkpoint(tmp_path, tree, device="cpu")
    assert torch.equal(got["x"], tree["x"])


# -- the watchdog -------------------------------------------------------------------

def test_watchdog_flags_straggler():
    for cls in (Watchdog, RefWatchdog):
        wd = cls(factor=2.0, min_deadline_s=0.0, window=5,
                 clock=lambda: 0.0)
        for _ in range(5):
            wd.run_step(lambda: None, fault_injector=lambda: 1.0)
        assert wd.deadline() == 2.0
        with pytest.raises(Exception) as err:
            wd.run_step(lambda: None, fault_injector=lambda: 10.0)
        assert type(err.value).__name__ == "StepTimeout"
        wd.run_step(lambda: None, fault_injector=lambda: 1.0)
    assert issubclass(StepTimeout, RuntimeError)


def test_watchdog_window_bounds_history():
    for cls in (Watchdog, RefWatchdog):
        wd = cls(factor=2.0, min_deadline_s=0.0, window=3)
        assert wd.deadline() == float("inf")
        for s in [1.0] * 6 + [9.0] * 3:
            wd.observe(s)
        assert wd.deadline() == 18.0


# -- meshes ---------------------------------------------------------------------

def test_meshes_are_one_card_or_raise():
    # one card holds any (data, model) mesh of chips; an empty axis raises
    m = mesh.make_host_mesh(device="cpu")
    assert m.size == 1 and m.single_device
    assert mesh.make_chip_mesh(3, device="cpu").size == 3
    m = mesh.make_host_mesh(data=2, device="cpu")
    assert m.shape == (2, 1) and m.single_device
    with pytest.raises(ValueError, match="must be >= 1"):
        mesh.make_host_mesh(data=0, device="cpu")
    assert mesh.make_production_mesh().shape == (16, 16)


# -- the training driver ------------------------------------------------------------

def _run(arch, **kw):
    # the watchdog on a clock that stands still: a loaded host's slow step
    # must not restore or retry (the straggler test brings its own)
    cfg = reduced(get_config(arch))
    kw = {"steps": 6, "global_batch": 2, "seq_len": 16, "log_every": 100,
          "device": "cpu", "watchdog": Watchdog(clock=lambda: 0.0), **kw}
    return train.run_training(cfg, **kw)


@pytest.mark.parametrize("arch", ("rwkv6-1.6b", "qwen3-14b"))
def test_resume_equals_the_uninterrupted_run(arch, tmp_path):
    params, losses = _run(arch)
    d = tmp_path / "ck"
    _, first = _run(arch, stop_at=3, ckpt_dir=d, ckpt_every=100)
    assert ckpt.latest_step(d) == 3
    resumed_params, rest = _run(arch, ckpt_dir=d, ckpt_every=100)
    assert first + rest == losses
    for a, b in zip(tree_leaves(params), tree_leaves(resumed_params)):
        assert torch.equal(a, b)


def test_loss_falls_on_a_reduced_config():
    _, losses = _run("qwen3-14b", steps=30, lr=3e-3, global_batch=4,
                     seq_len=32)
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_injected_straggler_restores_the_checkpoint(tmp_path, capsys):
    calls = {"n": 0}

    def injector():
        calls["n"] += 1
        return 1e6 if calls["n"] == 5 else 0.0

    wd = Watchdog(factor=50.0, min_deadline_s=120.0, window=5,
                  clock=lambda: 0.0)
    _, losses = _run("rwkv6-1.6b", ckpt_dir=tmp_path / "ck", ckpt_every=3,
                     fault_injector=injector, watchdog=wd)
    out = capsys.readouterr().out
    assert "step 4:" in out and "restoring last checkpoint" in out
    # steps 0-3 ran, step 4 timed out and the run restarted from step 3
    assert len(losses) == 7 and all(np.isfinite(losses))
    assert ckpt.latest_step(tmp_path / "ck") == 6
    _, clean = _run("rwkv6-1.6b")
    assert losses[:4] == clean[:4] and losses[4:] == clean[3:]


def test_sattn_preflight_and_spmm_preflight_run(capsys):
    _run("longformer-1.4b", steps=1, spmm_chips=2)
    out = capsys.readouterr().out
    assert "sparse-attention preflight OK" in out
    assert "spmm shard preflight OK on 2 chip(s)" in out


def test_parallel_meshes_raise():
    # data- and model-parallel meshes train (tests/test_torch_elastic.py
    # holds their resume); a mesh with an empty axis raises
    with pytest.raises(ValueError, match="must be >= 1"):
        _run("qwen3-14b", data_parallel=0)
    with pytest.raises(ValueError, match="must be >= 1"):
        train.main(["--arch", "qwen3-14b", "--smoke", "--device", "cpu",
                    "--steps", "1", "--tp", "0"])
    _, losses = _run("qwen3-14b", steps=2, data_parallel=2, model_parallel=2)
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_cli_runs_on_the_cpu(capsys):
    assert train.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16"]) == 0
    assert "[train] done: first loss" in capsys.readouterr().out
