"""Config registry — one module per architecture (port of
``src/repro/configs/``)."""
import importlib

_ARCH_MODULES = (
    "qwen2_5_32b", "llama3_405b", "qwen3_14b", "qwen1_5_32b",
    "llama4_scout_17b_a16e", "mixtral_8x7b", "llama_3_2_vision_11b",
    "musicgen_large", "jamba_1_5_large_398b", "rwkv6_1_6b",
    "longformer_1_4b",
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
    ArchConfig, ShapeSpec, SHAPES, REGISTRY, get_config,
    all_arch_names, reduced, cell_supported, register)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "REGISTRY", "get_config",
           "all_arch_names", "reduced", "cell_supported", "register"]
