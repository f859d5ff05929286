"""The port's sharded train step against the reference's unsharded step:
the rwkv, vision, longformer and scout architectures (the check and its
tolerances are in ``test_torch_mesh_step_ref.py``)."""
import pytest

from test_torch_mesh_step_ref import ARCH_FILES, check_against_reference
from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCH_FILES[1])
def test_sharded_step_matches_reference_microbatched_step(arch):
    check_against_reference(arch)
