"""Analytic per-chip device-memory traffic (port of
``src/repro/analysis/memmodel.py``): the roofline memory term of a model
step (``hbm_traffic``, ``memory_seconds``) and of one fused SpMM launch
(``spmm_hbm_traffic``, the autotuner's).

The model-step model counts only true materialization points
(MaxText-style):

  train:   params (FSDP-gathered, read fwd+recompute+bwd) + grad/opt
           state traffic + per-layer activation boundaries (x6: w+r in
           fwd, recompute, bwd) + flash-attention KV re-reads + SSM
           chunk states + MoE dispatch buffers + logits/loss
  prefill: the forward-only subset + KV cache writes
  decode:  full param read (the classic decode floor) + KV cache read
           + state read/write

All quantities are per chip per step, in bytes.  The reference reads
its two production meshes' axis sizes from a constant; the port reads
them from the mesh it is given (``distributed.sharding.LogicalMesh``):
dp is the batch axes' product (pod x data), tp the model axis, and the
optimizer state shards over the data axis x tp only, so the multi-pod
mesh's pod axis stays pure data parallelism, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict

from .roofline import HBM_BW

BF16 = 2
F32 = 4


def _axis_sizes(mesh) -> Dict[str, int]:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return {"dp": sizes.get("pod", 1) * sizes.get("data", 1),
            "fsdp": sizes.get("data", 1), "tp": sizes.get("model", 1),
            "chips": math.prod(mesh.shape)}


def hbm_traffic(cfg, shape, mesh) -> Dict[str, float]:
    """Per-chip bytes of one step, by term, at the reference's defaults
    (``remat="full"``, ``chunk_q=512``), the dry run's."""
    ax = _axis_sizes(mesh)
    dp, tp = ax["dp"], ax["tp"]
    kind = shape.kind
    B = shape.global_batch
    S = shape.seq_len
    Bl = max(B // dp, 1)                     # per-chip batch
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    L = cfg.num_layers
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()

    t: Dict[str, float] = {}

    if kind == "decode":
        # decode floor: every (active) parameter is read once per token;
        # TP splits the read across the model axis
        t["params_read"] = n_active * BF16 / tp
        # KV cache: read k+v fully, write one slot
        n_attn = sum(1 for k in cfg.pattern if k == "attn") * cfg.num_periods
        T = min(cfg.sliding_window or S, S)
        kv_heads_l = max(cfg.num_kv_heads // tp, 1)
        t["kv_cache"] = (n_attn * Bl * T * kv_heads_l * cfg.head_dim
                         * BF16 * 2)
        # SSM / rwkv states r+w
        st = 0.0
        for k in cfg.pattern:
            if k == "mamba":
                st += (cfg.mamba_d_inner / tp) * cfg.mamba_state * F32 * 2
            if k == "rwkv":
                st += (cfg.num_heads / tp) * cfg.head_dim ** 2 * F32 * 2
        t["state"] = st * cfg.num_periods * Bl
        t["activations"] = L * Bl * 1 * D * BF16 * 4
        t["logits"] = Bl * 1 * (V / tp) * F32 * 2
        return t

    # train / prefill
    reads = 3 if kind == "train" else 1      # fwd + recompute + bwd
    # FSDP all-gathered params land in device memory once per traversal
    # per layer
    t["params_read"] = n_params * BF16 / tp * reads
    if kind == "train":
        # grads f32 w+r, opt m/v read+write (f32), param update w
        # (FSDP shards over the data axis x TP; the pod axis pure-DP)
        n_local = n_params / (ax["fsdp"] * tp)
        t["optimizer"] = n_local * (F32 * 2 + F32 * 4 + BF16)
    # activation boundaries: one residual tensor per layer
    act_traffic = 6 if kind == "train" else 2
    t["activations"] = L * Bl * S * D * BF16 * act_traffic
    # flash attention: per q-chunk the full KV panel is re-read
    n_attn = sum(1 for k in cfg.pattern if k == "attn") * cfg.num_periods
    if n_attn and cfg.num_kv_heads:
        nchunks = max(S // 512, 1)
        kv_heads_l = max(cfg.num_kv_heads // tp, 1)
        kv_bytes = S * kv_heads_l * cfg.head_dim * BF16 * 2
        eff = (min(cfg.sliding_window, S) / S if cfg.sliding_window else 0.5)
        t["attention_kv"] = (n_attn * Bl * nchunks * kv_bytes * eff
                             * (3 if kind == "train" else 1))
    # mamba chunk states hit device memory (B,chunk,Di/tp,N) per chunk
    n_mamba = sum(1 for k in cfg.pattern if k == "mamba") * cfg.num_periods
    if n_mamba:
        states = Bl * S * (cfg.mamba_d_inner / tp) * cfg.mamba_state * F32
        t["mamba_states"] = n_mamba * states * (3 if kind == "train" else 1)
    n_rwkv = sum(1 for k in cfg.pattern if k == "rwkv") * cfg.num_periods
    if n_rwkv:
        rkvw = Bl * S * (cfg.num_heads / tp) * cfg.head_dim * F32 * 4
        t["rwkv_streams"] = n_rwkv * rkvw * (3 if kind == "train" else 1)
    # MoE dispatch/combine buffers
    if cfg.moe:
        n_moe = sum(1 for i in range(cfg.period_len)
                    if cfg.ffn_kind(i) == "moe") * cfg.num_periods
        C = max(cfg.top_k, int(cfg.capacity_factor * S * cfg.top_k
                               / cfg.num_experts))
        e_l = max(cfg.num_experts // tp, 1)
        buf = Bl * e_l * C * D * BF16 * 2
        t["moe_buffers"] = n_moe * buf * (3 if kind == "train" else 1)
    # logits + loss
    t["logits"] = Bl * S * (V / tp) * F32 * (4 if kind == "train" else 2)
    return t


def memory_seconds(cfg, shape, mesh, *, hbm_bw: float = HBM_BW) -> float:
    """The memory term's seconds at ``hbm_bw`` (default the card's
    rate; the reference's default is its TPU's)."""
    tr = hbm_traffic(cfg, shape, mesh)
    return sum(tr.values()) / hbm_bw


def spmm_hbm_traffic(*, slots: int, cols_entries: int, padded_nnz: int,
                     ws_rows: int, d_pad: int,
                     itemsize: int = F32) -> Dict[str, float]:
    """Per-forward device-memory bytes of one fused SpMM dispatch, from
    the packed workspace's own counts — the memory term
    ``core.autotune`` ranks candidate plans with (only streams that
    actually cross device memory).

      vals_stream  the flat slot buffer, read once per d-tile sweep
      cols_stream  the descriptor column stream (int32)
      x_gather     one (1, d_pad) X row (VPU) or (bk, d_pad)-panel slice
                   amortized per slot — padded_nnz gathers of d_pad lanes
      y_write      the workspace output rows, written once
    """
    return {
        "vals_stream": float(slots) * itemsize,
        "cols_stream": float(cols_entries) * 4,
        "x_gather": float(padded_nnz) * d_pad * itemsize,
        "y_write": float(ws_rows) * d_pad * itemsize,
    }
