"""The four examples on the port (``examples/torch_*.py``) run on the CPU
at their smallest sizes, each holding the claim its reference example
makes: the quickstart's products match dense and ``ref``, the GCN
separates the two communities (accuracy > 0.9), serving generates every
requested token, and training lowers the loss, over a (1, 1) and a
(2, 2) mesh of CPU chips."""
import importlib.util
from pathlib import Path

import pytest

from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_examples_import_only_the_port():
    import ast
    for py in sorted(EXAMPLES.glob("torch_*.py")):
        roots = set()
        for node in ast.walk(ast.parse(py.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert "repro_torch" in roots, py
        assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, py
    assert len(list(EXAMPLES.glob("torch_*.py"))) == 4


def test_quickstart_matches_dense_and_ref():
    out = _example("quickstart").main(["--device", "cpu"])
    assert out == {"dense_ok": True, "fused_ok": True}


def test_gcn_separates_the_communities():
    out = _example("gnn_graphconv").main(["--device", "cpu"])
    assert out["accuracy"] > 0.9
    assert out["losses"][-1] < out["losses"][0]
    assert out["backend"] == "ref"


def test_gcn_sharded_aggregation_on_cpu_chips():
    out = _example("gnn_graphconv").main(["--device", "cpu", "--n-chips",
                                          "2", "--x-sharding", "rows"])
    assert out["accuracy"] > 0.9 and out["backend"] == "pallas_ell"


def test_serve_generates_every_token():
    outs = _example("serve_lm").main(["--device", "cpu", "--gen", "4"])
    assert sorted(outs) == ["llama-3.2-vision-11b", "mixtral-8x7b",
                            "rwkv6-1.6b"]
    assert all(tuple(o.shape) == (4, 28) for o in outs.values())


@pytest.mark.parametrize("mesh", (("1", "1"), ("2", "2")))
def test_training_lowers_the_loss(mesh):
    losses = _example("train_lm").main(
        ["--device", "cpu", "--steps", "8", "--batch", "4", "--seq", "16",
         "--dp", mesh[0], "--tp", mesh[1]])
    assert len(losses) == 8 and losses[-1] < losses[0]
