"""Carry the reference's state across to the port.

The reference's state is the SpMM instance — a ``CSRMatrix`` whose
structure is host numpy and whose values are a JAX array — the dense
operand, and the parameter pytrees of the GCN
(``examples/gnn_graphconv.py``), of the ``sattn`` layer and of a whole
decoder stack (``models.transformer.init_params``).
These take those as numpy arrays (what ``np.asarray`` gives for either
package) and build the port's objects, so one seeded instance or model
can feed both packages.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .core.csr import CSRMatrix
from .kernels.ops import resolve_device


def csr_from_numpy(shape, row_ptr, col_indices, vals, *,
                   device=None) -> CSRMatrix:
    """The port's ``CSRMatrix`` from the reference's fields; ``vals``
    becomes a float32 tensor on ``device`` (the card unless the caller
    passes ``device="cpu"``)."""
    return CSRMatrix(
        shape=tuple(int(s) for s in shape),
        row_ptr=np.asarray(row_ptr), col_indices=np.asarray(col_indices),
        vals=dense_from_numpy(vals, device=device))


def dense_from_numpy(x, *, device=None) -> torch.Tensor:
    """A float32 tensor on ``device`` holding the numpy array ``x``."""
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        resolve_device(device))


def params_from_numpy(params, *, device=None, requires_grad: bool = True):
    """A reference parameter pytree — a dict of arrays such as the GCN's
    ``{"w1": (D_IN, D_H), "w2": (D_H, CLASSES)}`` or the ``sattn`` slot's
    ``{"ln", "wq", "wk", "wv", "wo"}``, nested dicts allowed — as the
    same dict of float32 leaf tensors on ``device``, ready for
    ``torch.autograd``."""
    return {name: (params_from_numpy(value, device=device,
                                     requires_grad=requires_grad)
                   if isinstance(value, dict) else
                   dense_from_numpy(np.asarray(value), device=device)
                   .requires_grad_(requires_grad))
            for name, value in params.items()}


def model_params_from_numpy(params, *, device=None,
                            dtype: torch.dtype = torch.float32):
    """The reference's decoder-stack parameter pytree (``embed``,
    ``final_norm``, ``lm_head`` and ``period/slot{i}/{kind, ffn_dense,
    ffn_moe}``, each period leaf stacked over periods) as the port's
    tree of the same keys and shapes: ``dtype`` tensors on ``device``
    (the card unless ``"cpu"``), no grad.  The leaves that the reference
    keeps in float32 at every model dtype (:func:`keeps_float32`) stay
    float32."""
    return model_params_to(params_from_numpy(params, device=device,
                                             requires_grad=False),
                           dtype=dtype)


# leaves that the reference's init_params draws in float32 at every model
# dtype: the MoE router, mamba's scan parameters, rwkv's bonus, decay base,
# group norm and every low-rank (lora_*_a / lora_*_b) factor
FLOAT32_LEAVES = frozenset({"router", "dt_bias", "A_log", "D", "u", "w0",
                            "gn_w", "gn_b"})
_LORA = re.compile(r"lora_[a-z]+_[ab]")


def keeps_float32(name: str) -> bool:
    """Whether the leaf ``name`` stays float32 whatever the model dtype."""
    return name in FLOAT32_LEAVES or _LORA.fullmatch(name) is not None


def model_params_to(params, *, dtype=None, device=None):
    """A decoder-stack parameter tree with every leaf moved to ``dtype``
    and ``device`` (either ``None``: unchanged), the leaves that
    ``init_params`` keeps in float32 (:func:`keeps_float32`) kept so."""
    def leaf(name, t):
        return t.to(device, torch.float32 if keeps_float32(name) else dtype)

    return {name: model_params_to(value, dtype=dtype, device=device)
            if isinstance(value, dict) else leaf(name, value)
            for name, value in params.items()}
