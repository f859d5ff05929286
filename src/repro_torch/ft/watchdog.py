"""Straggler / hang mitigation for the training driver (port of
``src/repro/ft/watchdog.py``, pure Python, copied).

Every step has a deadline derived from a trailing-median step time; a
blown deadline marks the step failed, and the driver restores from the
last checkpoint.  The deadline logic is real and the failure is injected
by tests (through ``fault_injector`` and an injectable clock).  The
watchdog times what ``fn`` does on the host: a step on the card must end
in a read that waits for the device, and a step over several cards must
wait for each (``run_training``'s does both), or the deadline times
kernel launches rather than steps.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Optional


class StepTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class Watchdog:
    factor: float = 3.0            # deadline = factor * median step time
    min_deadline_s: float = 1.0
    window: int = 20
    # the time source is injectable so tests run the whole deadline
    # pipeline — calibration window, median, timeout — on a fake clock
    clock: Callable[[], float] = time.perf_counter
    _times: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=20))

    def __post_init__(self):
        # the history deque honours the configured window
        if self._times.maxlen != self.window:
            self._times = deque(self._times, maxlen=self.window)

    def deadline(self) -> float:
        if not self._times:
            return float("inf")     # no data yet: first steps unbounded
        med = sorted(self._times)[len(self._times) // 2]
        return max(self.factor * med, self.min_deadline_s)

    def observe(self, seconds: float):
        self._times.append(seconds)

    def run_step(self, fn: Callable, *args, fault_injector: Optional[
            Callable[[], float]] = None):
        """Run one step under the deadline.  fault_injector (tests)
        returns extra simulated seconds for this step."""
        deadline = self.deadline()
        t0 = self.clock()
        out = fn(*args)
        elapsed = self.clock() - t0
        if fault_injector is not None:
            elapsed += fault_injector()
        if elapsed > deadline:
            raise StepTimeout(
                f"step took {elapsed:.3f}s > deadline {deadline:.3f}s "
                f"(straggler suspected)")
        self.observe(elapsed)
        return out
