"""The port's sharded train step against the reference's unsharded step:
the architectures the other two files leave (the check and its
tolerances are in ``test_torch_mesh_step_ref.py``)."""
import pytest

from repro_torch.configs import all_arch_names

from test_torch_mesh_step_ref import ARCH_FILES, check_against_reference
from torch_mesh_fixtures import one_thread  # noqa: F401 (autouse)

REST = tuple(a for a in all_arch_names()
             if not any(a in f for f in ARCH_FILES))


@pytest.mark.parametrize("arch", REST)
def test_sharded_step_matches_reference_microbatched_step(arch):
    check_against_reference(arch)
