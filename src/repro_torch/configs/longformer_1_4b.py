"""longformer-1.4b [dense] — causal LM with longformer-style sparse
attention: every layer is a "sattn" slot (sliding-window + global key
columns), lowered through the fused SDDMM → segment-softmax → S·V
descriptor stream (DESIGN.md §13) instead of dense masked attention.
Dims follow the longformer-large stack scaled to a ~1.4B causal LM (the
reference's ``src/repro/configs/longformer_1_4b.py``, field for field).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="longformer-1.4b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
    head_dim=128, d_ff=8192, vocab_size=50265,
    pattern=("sattn",),
    sparse_attn_window=512, sparse_attn_global=64,
    rope_theta=1e4,
    notes="sparse-attention workload: the attention sandwich runs "
          "through compile_sparse_attention (one fused launch per "
          "(batch, head)); KV cache is full-length (global tokens must "
          "not be evicted)",
))
