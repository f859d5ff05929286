"""Architecture registry (port of ``src/repro/configs/base.py``, stdlib
only).

``ArchConfig`` carries the reference's fields one for one (and the
layer-pattern properties), so a configuration reads the same in both
packages; ``register``
adds one to :data:`REGISTRY`.  The port registers only the
configurations whose layers it runs: ``longformer-1.4b``, whose every
layer is a ``sattn`` slot.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int                # 0 for attention-free
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 1e4
    # sparse attention ("sattn" slots): causal local window plus
    # longformer-style global key columns, lowered through the fused
    # descriptor-stream sandwich (DESIGN.md §13)
    sparse_attn_window: Optional[int] = None
    sparse_attn_global: int = 0
    # layer pattern: slot kinds repeated over depth
    pattern: Tuple[str, ...] = ("attn",)
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # MoE FFN on layers where idx%every==every-1
    capacity_factor: float = 1.25
    # mamba (hybrid)
    mamba_state: int = 16
    mamba_conv: int = 4
    mamba_expand: int = 2
    # vlm
    num_image_tokens: int = 0
    # modality / misc
    modality: str = "text"           # text | audio_codes | vision_text
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def period_len(self) -> int:
        return len(self.pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period_len == 0, self.name
        return self.num_layers // self.period_len


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import longformer_1_4b  # noqa: F401  (registers on import)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
