# Port of src/repro/ft/: checkpoint/restart, elastic re-meshing and the
# straggler watchdog.
from . import checkpoint, elastic
from .watchdog import StepTimeout, Watchdog

__all__ = ["checkpoint", "elastic", "StepTimeout", "Watchdog"]
