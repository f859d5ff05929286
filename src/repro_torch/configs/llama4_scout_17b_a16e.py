"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
(The reference's ``src/repro/configs/llama4_scout_17b_a16e.py``, field for field.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    moe=True, num_experts=16, top_k=1, rope_theta=5e5,
    notes="MoE every layer (simplification of llama4's interleave); "
          "early-fusion frontend is a stub per task spec.",
))
