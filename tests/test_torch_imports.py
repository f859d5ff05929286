"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax``, ``ml_dtypes`` (which the card's machine lacks) nor the
reference package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def port_modules():
    for py in sorted(PORT.rglob("*.py")):
        rel = py.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def imported_roots(path):
    """Top-level package of every absolute import in the file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for name in {list(port_modules())!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def test_every_slice_module_is_covered():
    # the scans above walk the package; these are the modules each
    # slice added, so a package layout change cannot drop them silently
    modules = set(port_modules())
    for name in ("repro_torch.core.spmm", "repro_torch.kernels.attn_fused",
                 "repro_torch.kernels.spmm_ell_fused", "repro_torch.gnn",
                 "repro_torch.configs.base",
                 "repro_torch.configs.longformer_1_4b",
                 "repro_torch.models.layers",
                 "repro_torch.models.sparse_attention",
                 "repro_torch.kernels.sddmm", "repro_torch.kernels.spmm_csr",
                 "repro_torch.kernels.spmm_bcsr", "repro_torch.distributed",
                 "repro_torch.distributed.sharding",
                 "repro_torch.distributed.collectives",
                 "repro_torch.core.autotune", "repro_torch.analysis.roofline",
                 "repro_torch.analysis.memmodel", "repro_torch.data",
                 "repro_torch.data.pipeline", "repro_torch.launch",
                 "repro_torch.launch.serve", "repro_torch.core.moe_spmm",
                 "repro_torch.models.moe", "repro_torch.models.transformer",
                 "repro_torch.models.model", "repro_torch.convert",
                 "repro_torch.configs.qwen2_5_32b",
                 "repro_torch.configs.qwen3_14b",
                 "repro_torch.configs.qwen1_5_32b",
                 "repro_torch.configs.llama3_405b",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.configs.musicgen_large",
                 "repro_torch.configs.llama_3_2_vision_11b",
                 "repro_torch.configs.jamba_1_5_large_398b",
                 "repro_torch.configs.rwkv6_1_6b",
                 "repro_torch.models.mamba", "repro_torch.models.rwkv6",
                 "repro_torch.pytree", "repro_torch.optim",
                 "repro_torch.optim.adamw", "repro_torch.optim.compression",
                 "repro_torch.train", "repro_torch.train.train_step",
                 "repro_torch.ft", "repro_torch.ft.checkpoint",
                 "repro_torch.ft.watchdog", "repro_torch.launch.mesh",
                 "repro_torch.launch.train", "repro_torch.ft.elastic",
                 "repro_torch.launch.dryrun", "repro_torch.analysis",
                 "repro_torch.distributed.model_split"):
        assert name in modules, name
    for src in ("attn_trips.cuh", "attn_fused.cu", "attn_fused_staged.cu",
                "sddmm.cu", "spmm_ell_segment.cu", "spmm_bcsr.cu",
                "spmm_gather_ring.cuh", "occupancy.cuh"):
        assert (PORT / "kernels" / "csrc" / src).is_file(), src


def test_mesh_slice_names_are_ported():
    # the names the mesh slice ports, each where the reference has it
    import importlib
    for module, names in (
            ("repro_torch.distributed.sharding",
             ("AxisEnv", "resolve_spec", "param_pspec", "cache_pspec",
              "param_shardings", "batch_shardings", "decode_shardings",
              "logits_sharding", "replicated", "chip_row_sharding")),
            ("repro_torch.distributed.collectives", ("compressed_psum",)),
            # the model axis's compute split
            ("repro_torch.distributed.sharding",
             ("model_dim", "owned_range", "gather_slice")),
            ("repro_torch.distributed.collectives",
             ("model_sum", "vocab_max", "vocab_sumexp", "vocab_target")),
            ("repro_torch.distributed.model_split",
             ("ModelSplit", "SplitTally", "kv_heads")),
            ("repro_torch.models.transformer", ("forward_train_parts",)),
            ("repro_torch.models.model", ("vocab_parallel_cross_entropy",)),
            ("repro_torch.ft.elastic", ("ElasticPlan", "plan_remesh",
                                        "build_mesh", "remesh_state")),
            ("repro_torch.analysis.memmodel", ("hbm_traffic",
                                               "memory_seconds")),
            ("repro_torch.analysis.roofline", ("model_flops_for_cell",
                                               "peak_flops")),
            ("repro_torch.launch.dryrun", ("dryrun_cell", "main"))):
        mod = importlib.import_module(module)
        for name in names:
            assert hasattr(mod, name), (module, name)
        bad = imported_roots(PORT.parent / (module.replace(".", "/")
                                            + ".py")) & set(FORBIDDEN)
        assert not bad, (module, bad)


def test_port_sources_import_no_jax_or_reference():
    for py in sorted(PORT.rglob("*.py")):
        bad = imported_roots(py) & set(FORBIDDEN)
        assert not bad, (py, bad)


def test_chip_smoke_imports_no_jax_or_reference():
    roots = imported_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots
    assert not roots & set(FORBIDDEN), roots


def test_chip_smoke_fails_without_a_card():
    # without CUDA it must exit non-zero and print no result line
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
