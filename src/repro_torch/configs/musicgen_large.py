"""musicgen-large [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]
(The reference's ``src/repro/configs/musicgen_large.py``, field for field.)
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    modality="audio_codes",
    notes="EnCodec frontend is a stub: the decoder consumes audio-code "
          "token ids directly (single-stream simplification of the "
          "4-codebook delay pattern).",
))
