"""The model-level analysis and the meta-device dry run
(``repro_torch.analysis.{memmodel,roofline}``,
``repro_torch.launch.dryrun``).

- ``hbm_traffic``, ``memory_seconds`` and ``model_flops_for_cell`` for
  the 11 architectures x 4 shapes on the reference's two production
  meshes equal the reference's exactly (the port reads the axis sizes
  from the mesh; the reference from a constant), at the dry run's
  ``remat="full"`` and ``chunk_q=512``.  ``memory_seconds`` is compared
  at the reference's default rate, passed explicitly.
- The dry run completes for every supported cell on the ``single``,
  ``multi`` and ``card`` meshes, on ``meta``: per-chip argument bytes x
  chips >= the trees' bytes, equal on the one-chip mesh, and the CLI
  writes one record a cell.
"""
import json

import pytest

from repro.analysis import memmodel as ref_memmodel
from repro.analysis import roofline as ref_roofline
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro_torch.analysis import memmodel, roofline
from repro_torch.configs import SHAPES, all_arch_names, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.optim import AdamW
from repro_torch.pytree import tree_leaves

ARCHS = all_arch_names()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_analysis_equals_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        shape, rshape = SHAPES[name], REF_SHAPES[name]
        assert roofline.model_flops_for_cell(cfg, shape) == \
            ref_roofline.model_flops_for_cell(rcfg, rshape)
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            # the port is fixed at the dry run's remat and chunk_q
            want = ref_memmodel.hbm_traffic(rcfg, rshape, multi_pod=multi,
                                            remat="full", chunk_q=512)
            got = memmodel.hbm_traffic(cfg, shape, mesh)
            assert got == want, (name, multi)
            assert memmodel.memory_seconds(cfg, shape, mesh,
                                           hbm_bw=819e9) == \
                ref_memmodel.memory_seconds(rcfg, rshape, multi_pod=multi)
            assert memmodel.memory_seconds(cfg, shape, mesh) == \
                sum(got.values()) / roofline.HBM_BW


def test_optimizer_state_shards_over_the_data_axis_only():
    # the reference's n_params / (16 * tp) on the multi-pod mesh too
    cfg = get_config("qwen3-14b")
    shape = SHAPES["train_4k"]
    single = memmodel.hbm_traffic(cfg, shape, make_production_mesh())
    multi = memmodel.hbm_traffic(cfg, shape,
                                 make_production_mesh(multi_pod=True))
    assert single["optimizer"] == multi["optimizer"]
    assert single["activations"] == 2 * multi["activations"]
    card = memmodel.hbm_traffic(cfg, shape, dryrun.make_mesh("card"))
    assert card["optimizer"] == 256 * single["optimizer"]


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("mesh_name", dryrun.MESHES)
def test_dry_run_covers_every_supported_cell(mesh_name, tmp_path):
    for arch in ARCHS:
        model = Model(get_config(arch))
        params = model.param_shapes()
        whole = {"params": _tree_bytes(params)}
        for name, shape in SHAPES.items():
            rec = dryrun.dryrun_cell(arch, name, mesh_name, out_dir=tmp_path)
            supported, _ = dryrun.cell_supported(model.cfg, shape)
            if not supported:
                assert rec["status"] == "skip"
                continue
            assert rec["status"] == "ok", rec.get("error")
            chips = rec["chips"]
            assert chips == {"single": 256, "multi": 512, "card": 1}[
                mesh_name]
            parts = rec["breakdown"]
            if shape.kind == "train":
                whole["opt_state"] = _tree_bytes(AdamW().init(params))
            assert parts["params"] * chips >= whole["params"]
            if mesh_name == "card":
                assert parts["params"] == whole["params"]
                if shape.kind == "train":
                    assert parts["opt_state"] == whole["opt_state"]
                assert rec["arguments_fit_card"] == (
                    rec["argument_bytes_per_chip"] <= 80 * 2 ** 30)
            assert rec["argument_bytes_per_chip"] == sum(parts.values())
            assert rec["bottleneck"] in ("compute", "memory")
            # the compute term at the card's peak for the model's dtype
            peak = {"bfloat16": 989e12, "float32": 67e12}[model.cfg.dtype]
            assert rec["compute_s"] == rec["model_flops"] / (chips * peak)
            assert rec["model_flops"] > 0 and rec["memory_s"] > 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == len(ARCHS) * len(SHAPES)
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["mesh"] == dryrun.MESH_NAMES[mesh_name]


def test_dry_run_cli(tmp_path, capsys):
    assert dryrun.main(["--arch", "longformer-1.4b", "--shape", "train_4k",
                        "--mesh", "card", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "longformer-1.4b__train_4k__card1x1: ok" in out
    assert "arguments_fit_card=True" in out
    rec = json.loads((tmp_path / "longformer-1.4b__train_4k__card1x1.json")
                     .read_text())
    # bf16 params, float32 moments and the batch's int32 tokens/labels
    n = sum(t.numel() for t in tree_leaves(
        Model(get_config("longformer-1.4b")).param_shapes()))
    assert rec["breakdown"]["params"] == 2 * n
    assert rec["breakdown"]["opt_state"] == 8 * n + 4
    assert rec["breakdown"]["batch"] == 2 * 256 * 4096 * 4
