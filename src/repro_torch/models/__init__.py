# The model stack the port runs (port of src/repro/models/): the layer
# functions, the sparse-attention "sattn" slot, the recurrent mamba and
# rwkv slots, the MoE FFN, the decoder stack and the Model facade.
from . import (layers, mamba, model, moe, rwkv6, sparse_attention,
               transformer)
from .model import Model, cross_entropy_loss
from .sparse_attention import (sparse_attention_mask,
                               sparse_self_attention_layer)

__all__ = ["layers", "mamba", "model", "moe", "rwkv6", "sparse_attention",
           "transformer", "Model", "cross_entropy_loss",
           "sparse_attention_mask", "sparse_self_attention_layer"]
