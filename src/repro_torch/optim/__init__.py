# Port of src/repro/optim/: AdamW and int8 gradient compression.
from .adamw import AdamW, AdamWState, warmup_cosine
from .compression import compress_decompress, make_error_feedback_transform

__all__ = ["AdamW", "AdamWState", "warmup_cosine", "compress_decompress",
           "make_error_feedback_transform"]
