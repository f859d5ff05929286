"""Architecture + shape registries (port of ``src/repro/configs/base.py``,
stdlib only).

``ArchConfig`` carries the reference's fields, properties and analytic
parameter counts one for one, so a configuration reads the same in both
packages; ``register`` adds one to :data:`REGISTRY`.  ``SHAPES`` are the
reference's four input-shape cells and ``reduced`` its CPU-sized smoke
variant, field for field.  The registry holds the reference's eleven
architectures.
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

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def attention_free(self) -> bool:
        return all(k in ("mamba", "rwkv") for k in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid state layers, SWA, or
        sparse attention (O(S*(window+global)) scores)."""
        return (any(k in ("mamba", "rwkv") for k in self.pattern)
                or self.sliding_window is not None
                or (self.sparse_attn_window is not None
                    and "sattn" in self.pattern))

    def ffn_kind(self, slot_idx: int) -> str:
        if self.pattern[slot_idx] == "rwkv":
            return "none"            # channel-mix is built into the block
        if self.moe and (slot_idx % self.moe_every == self.moe_every - 1):
            return "moe"
        return "dense"

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline ratios)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = V * D * 2            # embed + head
        for i, kind in enumerate(self.pattern):
            n = self.num_periods
            if kind in ("attn", "sattn"):
                # sattn reuses the attn projection stack; only the
                # score/AV contraction differs (mask-structured)
                total += n * (D * hd * (H + 2 * KV) + H * hd * D + 2 * D)
                if self.qkv_bias:
                    total += n * hd * (H + 2 * KV)
            elif kind == "xattn":
                total += n * (D * hd * (H + 2 * KV) + H * hd * D + 2 * D)
            elif kind == "mamba":
                Di, N, R = self.mamba_d_inner, self.mamba_state, self.mamba_dt_rank
                total += n * (D * 2 * Di + self.mamba_conv * Di
                              + Di * (R + 2 * N) + R * Di + Di * N
                              + 2 * Di + Di * D + D)
            elif kind == "rwkv":
                N = hd
                total += n * (4 * D * H * N + H * N * D
                              + 4 * (D * 32 + 32 * D) + D * 64 + 64 * D
                              + 5 * D + 4 * H * N + 2 * D * F + D * D + 8 * D)
            fk = self.ffn_kind(i)
            if fk == "dense":
                total += n * (3 * D * F + D)
            elif fk == "moe":
                E = self.num_experts
                total += n * (D * E + E * 3 * D * F + D)
        total += D                    # final norm
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of E experts)."""
        if not self.moe:
            return self.param_count()
        D, F, E, k = self.d_model, self.d_ff, self.num_experts, self.top_k
        inactive_experts = 0
        for i in range(self.period_len):
            if self.ffn_kind(i) == "moe":
                inactive_experts += self.num_periods * (E - k)
        return self.param_count() - inactive_experts * 3 * D * F


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(supported, reason-if-not) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 512k decode needs "
                       "sub-quadratic attention (DESIGN.md §9)")
    return True, ""


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import registers all arch modules on first use
    from . import _load_all
    _load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_arch_names():
    from . import _load_all
    _load_all()
    return sorted(REGISTRY)


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/pattern, tiny dims (CPU-runnable)."""
    E = min(cfg.num_experts, 4) if cfg.moe else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=cfg.period_len * 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=E,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        # generous capacity so train/decode routing agree (no drops) in
        # consistency tests; production keeps 1.25
        capacity_factor=4.0,
        sliding_window=8 if cfg.sliding_window else None,
        sparse_attn_window=8 if cfg.sparse_attn_window else None,
        sparse_attn_global=min(cfg.sparse_attn_global, 2),
        mamba_state=4,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
        dtype="float32",
    )
