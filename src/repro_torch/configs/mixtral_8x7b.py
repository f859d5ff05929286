"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
(The reference's ``src/repro/configs/mixtral_8x7b.py``, field for field.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000,
    moe=True, num_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1e6,
    notes="SWA(4096) makes long_500k decode sub-quadratic (ring KV "
          "cache of window size). E=8 not divisible by TP=16 -> expert "
          "d_ff sharded instead (TP-MoE).",
))
