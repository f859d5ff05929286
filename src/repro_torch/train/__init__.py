# Port of src/repro/train/: the train, serve and prefill step builders.
from .train_step import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]
