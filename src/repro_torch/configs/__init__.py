# Architecture configurations (port of src/repro/configs/); only the
# ones whose layers the port runs are registered.
from .base import REGISTRY, ArchConfig, get_config, register

__all__ = ["REGISTRY", "ArchConfig", "get_config", "register"]
