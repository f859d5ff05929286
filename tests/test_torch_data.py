"""The port's ``DeviceStage`` (``data/pipeline.py``) on the CPU: the
reference's lifecycle tests (``tests/test_data.py``) on the port's
stage, the default transfer's CPU form, and the stage beside the
reference's on the same source.  The card's side-stream copy is tested
in ``tests/test_torch_serve_cuda.py``."""
import time

import numpy as np
import pytest
import torch

from repro.data.pipeline import DeviceStage as RefDeviceStage
from repro_torch.data import DeviceStage


def test_device_stage_order_and_values():
    items = list(range(10))
    out = list(DeviceStage(items, depth=2, transfer=lambda v: v * 10))
    assert out == [(i, i * 10) for i in items]


def test_device_stage_yields_what_the_reference_stage_yields():
    def source():
        for i in range(7):
            yield i, [i, i * i]

    def transfer(item):
        return sum(item[1]) + item[0]

    want = list(RefDeviceStage(source(), depth=3, transfer=transfer))
    assert list(DeviceStage(source(), depth=3, transfer=transfer)) == want


def test_device_stage_empty_source():
    assert list(DeviceStage([], transfer=lambda v: v)) == []


def test_device_stage_rejects_bad_depth():
    with pytest.raises(ValueError, match="depth"):
        DeviceStage([1], depth=0, transfer=lambda v: v)


def test_device_stage_propagates_source_exception():
    def src():
        yield 1
        yield 2
        raise RuntimeError("upstream pack failed")

    it = iter(DeviceStage(src(), transfer=lambda v: v))
    assert next(it) == (1, 1)
    assert next(it) == (2, 2)
    with pytest.raises(RuntimeError, match="upstream pack failed"):
        next(it)


def test_device_stage_propagates_transfer_exception():
    def bad_transfer(v):
        if v == 3:
            raise ValueError("transfer blew up")
        return v

    it = iter(DeviceStage([1, 2, 3, 4], transfer=bad_transfer))
    assert next(it) == (1, 1)
    assert next(it) == (2, 2)
    with pytest.raises(ValueError, match="transfer blew up"):
        next(it)


def test_device_stage_prefetches_ahead():
    """The worker stages item k+1 while the consumer still holds item k."""
    staged = []

    def transfer(v):
        staged.append(v)
        return v

    stage = iter(DeviceStage(range(6), depth=2, transfer=transfer))
    assert next(stage) == (0, 0)
    deadline = time.time() + 5.0
    while len(staged) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert len(staged) >= 3
    assert list(stage) == [(i, i) for i in range(1, 6)]


def test_device_stage_close_joins_abandoned_worker():
    stage = DeviceStage(range(100), depth=1, transfer=lambda v: v)
    it = iter(stage)
    assert next(it) == (0, 0)            # consume one, then walk away
    stage.close()
    assert not stage._thread.is_alive()
    assert list(it) == []                # post-close iteration ends


def test_device_stage_close_unblocks_producer_error_path():
    def src():
        yield 1                          # fills the depth-1 queue
        raise RuntimeError("producer died mid-batch")

    stage = DeviceStage(src(), depth=1, transfer=lambda v: v)
    stage.close()                        # never consumed
    assert not stage._thread.is_alive()


def test_device_stage_context_manager_closes():
    with DeviceStage(range(50), depth=2, transfer=lambda v: v) as stage:
        it = iter(stage)
        assert next(it) == (0, 0)
    assert not stage._thread.is_alive()
    with DeviceStage([1, 2], transfer=lambda v: v) as stage2:
        assert list(stage2) == [(1, 1), (2, 2)]
    assert not stage2._thread.is_alive()


def test_default_transfer_on_the_cpu_makes_tensors():
    rng = np.random.default_rng(0)
    items = [("job", i, (rng.standard_normal((3, 4)).astype(np.float32),
                         {"ids": np.arange(i + 1)}))
             for i in range(4)]
    with DeviceStage(items, depth=2, device="cpu") as stage:
        out = list(stage)
    assert [item for item, _ in out] == items
    for (_, i, (x, d)), (_, (tag, j, (xt, dt))) in zip(items, out):
        assert (tag, j) == ("job", i)     # other leaves pass through
        assert isinstance(xt, torch.Tensor) and xt.device.type == "cpu"
        np.testing.assert_array_equal(xt.numpy(), x)
        np.testing.assert_array_equal(dt["ids"].numpy(), d["ids"])


def test_default_transfer_needs_a_device(monkeypatch):
    # no card: a stage for the card raises at construction, as
    # resolve_device does, and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceStage([np.zeros(3)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceStage([np.zeros(3)], device="cuda")
