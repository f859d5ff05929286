"""qwen2.5-32b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]
(The reference's ``src/repro/configs/qwen2_5_32b.py``, field for field.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    notes="GQA kv=8; QKV bias; heads(40) not divisible by TP=16 -> "
          "attention weights FSDP-only (DESIGN.md sharding fallback).",
))
