"""Config registry — one module per architecture the port runs (port of
``src/repro/configs/``; ``NOT_PORTED`` names the two that wait for the
recurrent slots)."""
import importlib

_ARCH_MODULES = (
    "qwen2_5_32b", "llama3_405b", "qwen3_14b", "qwen1_5_32b",
    "llama4_scout_17b_a16e", "mixtral_8x7b", "llama_3_2_vision_11b",
    "musicgen_large", "longformer_1_4b",
)

_loaded = False


def _load_all():
    global _loaded
    if _loaded:
        return
    _loaded = True
    for mod in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{mod}")


from .base import (  # noqa: E402
    ArchConfig, ShapeSpec, SHAPES, REGISTRY, NOT_PORTED, get_config,
    all_arch_names, reduced, cell_supported, register)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "REGISTRY", "NOT_PORTED",
           "get_config", "all_arch_names", "reduced", "cell_supported",
           "register"]
