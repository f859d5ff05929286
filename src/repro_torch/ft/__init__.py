# Port of src/repro/ft/: checkpoint/restart and the straggler watchdog.
from . import checkpoint
from .watchdog import StepTimeout, Watchdog

__all__ = ["checkpoint", "StepTimeout", "Watchdog"]
