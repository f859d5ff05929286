"""A fixture the mesh tests share: one intra-op thread while a test runs.

The tier-1 command runs six pytest workers on the machine's cores, and
a small CPU op fanned out over every core then waits on the other
workers' threads: the mesh tests' thousands of small ops crawled (a
2-s test took 50 s).  One thread each keeps them fast.  Every check in
them compares results computed within the test, or against the
reference's, at the tolerance each states, so the thread count changes
no verdict.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
