"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7, MoE 16e top-2
(the reference's ``src/repro/configs/jamba_1_5_large_398b.py``, field
for field).  [arXiv:2403.19887; hf]"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=24576, vocab_size=65536,
    pattern=("mamba", "mamba", "mamba", "mamba",
             "attn", "mamba", "mamba", "mamba"),
    moe=True, num_experts=16, top_k=2, moe_every=2,
    mamba_state=16, mamba_conv=4, mamba_expand=2,
    notes="1 attention layer per 8 (1:7 attn:mamba); MoE FFN on every "
          "other layer; long_500k supported (attn KV cache is the only "
          "seq-length-bound state; mamba state is O(1)).",
))
