"""qwen1.5-32b [dense] — QKV bias, MHA-like kv=40. [hf:Qwen/Qwen1.5-0.5B; hf]
(The reference's ``src/repro/configs/qwen1_5_32b.py``, field for field.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    head_dim=128, d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
))
