"""rwkv6-1.6b 'Finch' [ssm] — attention-free, data-dependent decay (the
reference's ``src/repro/configs/rwkv6_1_6b.py``, field for field).
[arXiv:2404.05892; unverified]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=0,
    head_dim=64, d_ff=7168, vocab_size=65536,
    pattern=("rwkv",),
    notes="attention-free; decode state is O(1) per layer: "
          "(B,H,64,64) wkv state + token-shift buffers. The paper's "
          "SpMM technique is N/A in-stack (DESIGN.md §8).",
))
