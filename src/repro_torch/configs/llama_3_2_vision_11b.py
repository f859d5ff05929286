"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
(The reference's ``src/repro/configs/llama_3_2_vision_11b.py``, field for field.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=128256,
    pattern=("attn", "attn", "attn", "xattn", "attn"),
    num_image_tokens=1600, rope_theta=5e5, modality="vision_text",
    notes="vision frontend is a stub: input_specs provides precomputed "
          "patch embeddings (B, 1600, D). Cross-attn layers interleaved "
          "1-in-5 (gated residual).",
))
