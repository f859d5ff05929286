import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason elsewhere")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
