# The model layers the port runs (port of src/repro/models/): the
# longformer "sattn" slot and the layer functions it uses.
from . import layers, sparse_attention
from .sparse_attention import (sparse_attention_mask,
                               sparse_self_attention_layer)

__all__ = ["layers", "sparse_attention", "sparse_attention_mask",
           "sparse_self_attention_layer"]
