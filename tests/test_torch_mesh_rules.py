"""The port's logical-axis rules (``repro_torch.distributed.sharding``)
against the reference's, exactly.

The reference's rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in mesh (``SimpleNamespace`` with an
object array of that shape) runs them in-process at the production
sizes, with no 512 host devices; ``NamedSharding`` is swapped for a
function that returns the spec, so the reference's ``param_shardings``,
``batch_shardings``, ``decode_shardings``, ``logits_sharding``,
``replicated`` and ``chip_row_sharding`` hand back bare specs.  Every
leaf of every architecture at full size (the reference's tree from
``jax.eval_shape`` of its ``init_params`` closed over the config, the
port's from ``Model.param_shapes`` on ``meta``), on the meshes (1, 1),
(8, 1), (2, 4), (16, 16) and (2, 16, 16): the specs are equal entry for
entry.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_sharding
from repro.models import transformer as ref_transformer
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch.configs import SHAPES, all_arch_names, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves_with_path

ARCHS = all_arch_names()
MESHES = {(1, 1): ("data", "model"), (8, 1): ("data", "model"),
          (2, 4): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


@pytest.fixture
def ref(monkeypatch):
    """The reference's sharding module with NamedSharding -> the spec."""
    monkeypatch.setattr(ref_sharding, "NamedSharding",
                        lambda mesh, spec: spec)
    return ref_sharding


def _meshes(shape):
    axes = MESHES[shape]
    fake = SimpleNamespace(axis_names=axes,
                           devices=np.empty(shape, dtype=object))
    port = sharding.LogicalMesh(axes, shape, ("meta",) * int(np.prod(shape)))
    return fake, port


def _spec(s):
    return tuple(s)


def _ref_specs(tree):
    return [(jax.tree_util.keystr(p), _spec(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]]


def _port_specs(tree):
    return [p.spec for _, p in tree_leaves_with_path(tree)]


def _same(want, got):
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        assert w == tuple(g), (path, w, g)


def _ref_params(arch):
    rcfg = ref_get_config(arch)
    return jax.eval_shape(lambda r: ref_transformer.init_params(rcfg, r),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_serve_specs_match_reference_at_full_size(arch, ref):
    want_tree = _ref_params(arch)
    meta = Model(get_config(arch)).param_shapes()
    want_opt = jax.eval_shape(RefAdamW().init, want_tree)
    opt_meta = AdamW().init(meta)
    for shape in MESHES:
        fake, mesh = _meshes(shape)
        for mode in ("train", "serve_replicated"):
            _same(_ref_specs(ref.param_shardings(want_tree, fake, mode=mode)),
                  _port_specs(sharding.param_shardings(meta, mesh,
                                                       mode=mode)))
        # the optimizer state's paths (.count, .mu/..., .nu/...)
        _same(_ref_specs(ref.param_shardings(want_opt, fake)),
              _port_specs(sharding.param_shardings(opt_meta, mesh)))
        # param_pspec leaf by leaf through the reference's own env
        env, penv = ref.AxisEnv(fake), sharding.AxisEnv(mesh)
        flat = jax.tree_util.tree_flatten_with_path(want_tree)[0]
        for (rpath, leaf), (path, m) in zip(flat,
                                            tree_leaves_with_path(meta)):
            assert ref._path_str(rpath) == sharding._path_str(path)
            assert _spec(ref.param_pspec(rpath, leaf.shape, env)) == \
                sharding.param_pspec(path, tuple(m.shape), penv)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_decode_and_logits_specs_match_reference(arch, ref):
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    model, rmodel = Model(cfg), RefModel(rcfg)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        rshape, shape = REF_SHAPES[shape_name], SHAPES[shape_name]
        specs = model.input_specs(shape)
        want = jax.eval_shape(lambda: rmodel.input_specs(rshape))
        for mshape in MESHES:
            fake, mesh = _meshes(mshape)
            if shape.kind == "decode":
                _same(_ref_specs(ref.decode_shardings(want, fake)),
                      _port_specs(sharding.decode_shardings(specs, mesh)))
                env, penv = ref.AxisEnv(fake), sharding.AxisEnv(mesh)
                flat = jax.tree_util.tree_flatten_with_path(
                    want["caches"])[0]
                for (rpath, leaf), (path, m) in zip(
                        flat, tree_leaves_with_path(specs["caches"])):
                    assert _spec(ref.cache_pspec(rpath, leaf.shape, env)) \
                        == sharding.cache_pspec(path, tuple(m.shape), penv)
            else:
                _same(_ref_specs(ref.batch_shardings(want, fake)),
                      _port_specs(sharding.batch_shardings(specs, mesh)))
            for batch in (1, shape.global_batch, 48):
                assert _spec(ref.logits_sharding(fake, batch,
                                                  cfg.vocab_size)) == \
                    sharding.logits_sharding(mesh, batch,
                                             cfg.vocab_size).spec
            assert _spec(ref.replicated(fake)) == \
                sharding.replicated(mesh).spec == ()


def test_chip_row_sharding_and_resolve_spec_match_reference(ref):
    for n in (1, 4, 8):
        fake = SimpleNamespace(axis_names=("chips",),
                               devices=np.empty((n,), dtype=object))
        port = sharding.chip_mesh(n, device="cpu")
        assert _spec(ref.chip_row_sharding(fake)) == \
            sharding.chip_row_sharding(port).spec == ("chips",)
    fake, mesh = _meshes((2, 4))
    with pytest.raises(ValueError, match="1-D chip mesh"):
        ref.chip_row_sharding(fake)
    with pytest.raises(ValueError, match="1-D chip mesh"):
        sharding.chip_row_sharding(mesh)
    # candidates fall through on divisibility and on a reused axis
    for mshape in MESHES:
        fake, mesh = _meshes(mshape)
        env, penv = ref.AxisEnv(fake), sharding.AxisEnv(mesh)
        for shape in ((16, 32, 40), (8, 7, 64), (0, 4), (32, 32, 32, 32)):
            for rules in ({0: ["tp"], 1: ["fsdp"]},
                          {0: ["dp"], 1: ["sp"], 2: ["tp"]},
                          {0: ["tp"], 1: ["tp"], 2: ["fsdp"]},
                          {1: ["fsdp", "tp"], 3: ["dp"]}):
                assert _spec(ref.resolve_spec(shape, rules, env)) == \
                    sharding.resolve_spec(shape, rules, penv)


def test_production_and_host_meshes():
    single = port_mesh.make_production_mesh()
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == \
        (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, multi.shape, multi.size) == \
        (("pod", "data", "model"), (2, 16, 16), 512)
    assert {d.type for d in single.devices + multi.devices} == {"meta"}
    host = port_mesh.make_host_mesh(data=2, model=2, device="cpu")
    assert host.shape == (2, 2) and host.single_device
    assert host.coords(3) == {"data": 1, "model": 1}
    assert host.devices == (torch.device("cpu"),) * 4
    over = port_mesh.make_production_mesh(devices=["cpu"] * 300)
    assert over.size == 256
    with pytest.raises(ValueError, match="256 devices"):
        port_mesh.make_production_mesh(devices=["cpu"] * 8)
