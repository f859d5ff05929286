#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py        # from the repo root, one CUDA card
    python3 chip_smoke.py --ab-parent DIR [--ab-ptxas]
    python3 chip_smoke.py --cards 4    # four CUDA cards

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device  — a Hopper card (capability 9.0); its name and power limit
             as ``nvidia-smi`` reports them.
2. build   — compile the nine CUDA kernels (K1 ``spmm_ell_fused``, K2
             ``spmm_bcsr_fused``, K3 ``spmm_ell_fused_staged``, K4
             ``spmm_bcsr_fused_staged``, K5 ``attn_fused``, K6
             ``attn_fused_staged``, K7 ``sddmm``, K9 ``spmm_ell_segment``,
             K10 ``spmm_bcsr``) from ``src/repro_torch/kernels/csrc``
             into ``build/``, one ``nvcc`` per source, in parallel, and
             print ptxas's registers and spills for every template
             instance (bm; K7's by elements a lane), each beside the CTAs
             per SM the card reports for it (``<name>_ctas_per_sm``; the
             staged SpMM kernels at the 1024-entry slot, K2, K10, K9 and
             K1 at their X rings, the attention kernels at dh = 128, bk =
             8; K1's and K10's one-thread-a-column bodies in the CTAs of
             d_pad 47 and 200).  K5 runs on K6's CTA template
             (``attn_ring.cuh``); K1 and K10 on the gather ring at planned
             widths (``spmm_gather_ring.cuh``).
3. kernels — each kernel against its plain PyTorch version on the card
             (rtol = atol = 1e-5; K1 and K2 also ``torch.equal``), and
             each staged kernel against its resident twin
             (``torch.equal``: K3 = K1, K4 = K2): every strategy x
             merge_threshold {0, 16} once, the widths d {16, 100, 128,
             640} and row blocks in turn beside them (a covering subset
             of their product), on a mixed VPU/MXU fixture, one with
             empty rows and an empty matrix, also with a 64-entry
             staging slot; plus, one configuration a backend, a hub
             row and a dense 8-row block-row whose windows exceed the
             slot (and shared memory), which must take the chunked walk.  Then
             K1 called directly at d_pad 47, 128 and 200 (both routes)
             at every bm, merged and not, bit for bit its plain version
             and K3.
4. main    — ``compile_spmm(a, 128)`` then a forward, through the entry
             points a user calls, on two 2^20-row instances: a uniform
             graph (16.8 M edges, pure VPU trips) and a banded stencil
             (MXU trips), for ``backend="auto"`` and, on the uniform one,
             ``"pallas_ell"``; with the default staging, which must
             resolve to ``"dma"`` (K3/K4), and with ``"resident"``
             (K1/K2).  Each output is held to the port's ``ref`` backend
             on the card (rtol = atol = 1e-4) and each staged output to
             the resident one (``torch.equal``); each forward must be
             exactly one fused dispatch and one kernel launch, and the
             kernels, their plain versions, the forward and
             ``torch.sparse.mm`` are timed, each kernel beside its bytes
             bound, its slot and nnz gather models (an X row per slot,
             padding included, or per nonzero), the achieved TB/s on the
             nnz model and its launch's CTAs per SM.  One
             ``torch.profiler`` window over two default forwards on the
             uniform graph prints device time by kernel and the device's
             idle share (or says that it recorded no device time).
5. train   — the 2-layer GCN of ``examples/gnn_graphconv.py`` at full
             width on the uniform graph plus self-loops (sym-normalised,
             ~17.8 M edges): 5 SGD steps with the default artifacts, 4
             staged launches and no dvals work a step, a falling loss,
             and step 0's weight gradients held to the ``ref`` backend
             (rtol = atol = 1e-4); the step time is printed, and dvals at
             the output width 47 through K7 timed beside the chunked
             torch SDDMM (the ``ref`` backend's, K7's form before), which
             K7 must beat.
6. grad    — dvals and dX of ``(A·X * G).sum()`` on the uniform graph
             through the default artifact, held to ``ref`` at 1e-4:
             dvals by one K7 launch (counted) against ``ref``'s chunked
             torch SDDMM, which K7 must beat at d = 128.
7. oracles — K7, K9 and K10 against their plain versions on small
             fixtures (rtol = atol = 1e-5): K7 through ``sddmm_csr`` at
             T {8, 128} x d {16, 100, 128, 640} with empty rows, ragged
             pair counts and an empty matrix, and called directly at
             unplanned widths; K9 on every segment of each strategy's
             plan at bm {1, 2, 4, 8}; K10 on ``BCSRMatrix`` padded to
             the global kmax at every bm x bk {1, 8} x d {16, 47, 128,
             200} and at bk = 128 (both routes), bit for bit its plain
             version.  Then at size, counted
             (each count zeroed just before, read just after, no plain
             version run): K7 through ``sddmm_csr`` on the uniform graph
             at d = 128, held to the grad phase's dvals and to ``ref``
             at 1e-4; K9 over every segment of the uniform graph's
             ``nnz_split`` plan, scattered back and held to K1's forward;
             K10 on the banded stencil at its global kmax, held to K2's
             forward (each at 1e-4, and bit equality reported).  Each
             kernel against its plain version at size (1e-5), and timed
             beside its bounds, its fused or chunked counterpart and the
             library call (``torch.sparse.sampled_addmm`` for K7,
             ``torch.sparse.mm`` for K9/K10).  Operands that start 4
             bytes past a 16-byte boundary: X of the default and the
             resident SpMM forward on the uniform graph, K and V of both
             fused backends' default and resident attention forwards at
             the layer's S = 4096, dY and X of K7, X of K9, each result
             bit for bit the aligned operands' result.
8. attention kernels — K5 and K6 against their plain versions on the
             card (rtol = atol = 1e-5) and K6 against K5 (``torch.equal``,
             at the default and a 64-entry slot) on the reference's
             weighted powerlaw mask, its multi-trip fixture (q x 12), its
             empty-rows fixture and a fixture whose windows exceed the
             staging slot, each of ``pallas_ell``, ``pallas_bcsr`` at bk
             = 8 and at bk = 1 x merge_threshold {0, 16} x bm {1, 2, 4,
             8, 16}; the fixtures must reach merged trips, MXU blocks at
             bk = 1 and 8, chunked VPU and MXU members, VPU descriptors
             whose steps end part-way through K6's group and whose rows
             differ in length.  K5 and K6 share one CTA body, so the
             plain versions are what holds each of them here; K5 alone
             also against its plain version at the head widths K6 does
             not take: ragged (dh 100, called directly), a ring of one
             stage (bm = 16, bk = 32, dh 1024) and none (LEAN, dh 4096),
             at rtol = atol = 1e-5.
9. attention — ``compile_sparse_attention`` on the longformer-1.4b mask
             (S = 32768, window 512, 64 global columns, 18.7 M nonzeros),
             one head, dh = dv = 128: ``pallas_bcsr`` and ``pallas_ell``
             with the default staging (``dma``: K6) and ``resident``
             (K5), one dispatch and one launch a forward, each held to
             the port's ``ref`` backend at 1e-4 and each staged output to
             the resident one bit for bit; kernel, forward, plain version
             and ``scaled_dot_product_attention`` with the dense boolean
             mask (the library yardstick) timed beside the bounds.
10. sattn  — the longformer-1.4b ``sattn`` layer at full width (d_model
             2048, 16 heads over 16 KV heads, head_dim 128, S = 4096,
             batch 1, float32, random weights from a seed): 16 K6 launches
             a forward; output and weight gradients held to the
             ``backend="ref"`` layer at 1e-4; forward and forward +
             backward timed; the backward's peak memory printed, and no
             kernel's plain version run on the way; CUDA events around
             each part of a forward split it into the 16 K6 calls, the
             Q/K/V projections, RoPE and the rest (each forward must make
             16, 1 and 2 such calls), and K6 alone on one head's
             operands gives its time a launch at S = 4096.
11. model  — the decoder stack (``models/``) on the card, seeded
             weights, checked at float32 and timed at float32 and at the
             configs' bfloat16, beside the card's name and power limit.
             (m1) longformer-1.4b at full width and depth (24 sattn
             layers, d_model 2048, 16 heads, vocab 50265, 1.8 B
             parameters): ``Model.loss_fn`` on batch 1 at S = 4096 makes
             exactly 384 K6 launches (counted) and no plain version runs;
             the loss is finite and near ln 50265; the logits are held to
             the same weights composed from the layer functions with the
             sattn layer on ``backend="ref"`` (rtol = atol = 1e-4); the
             forward and its 384 K6 calls timed by CUDA events.  (m2)
             ``generate`` on those weights, batch 4, prompt 1024, 32 new
             tokens: every token the decode loop's argmax, prefill's
             logits and each decode step's held to ``forward_train``'s
             (K6) on the generated sequence at 2e-3; prefill, a decode
             step and tokens/s timed.  (m3) mixtral-8x7b at full width,
             2 of 32 layers: on the first MoE layer's normed input (S =
             4096, C = 1280) ``dispatch`` is bit for bit Sᵀ·tokens
             through ``compile_spmm`` (K4 at d = 4096), ``combine``
             matches S·expert_out at 1e-5 and ``moe_apply_concrete(
             backend="auto")`` the gather path at rtol 1e-4, atol 1e-5
             (4 K4 launches, counted); K4 timed there beside its bound and
             ``torch.sparse.mm``; then ``loss_fn`` (finite) and
             ``generate`` (batch 4, prompt 512, 32 tokens) timed.  (m5)
             rwkv6-1.6b at full size (24 layers, d_model 2048, 1.6 B
             parameters): ``loss_fn`` at batch 1, S = 4096 at fp32 and
             bf16 (loss at ln V + σ²/2); a prefill of 512 and 256
             decode steps held to ``forward_train`` at 1e-4; ``generate``
             (batch 4, prompt 512, 32 tokens) with a decode step's
             launches under ``torch.profiler``.  (m6) jamba-1.5-large-
             398b's period cut to its first five slots at full width
             (mamba x 4 and attention, MoE on two; 44.8 GiB at bf16):
             ``loss_fn`` at batch 1, S = 4096 with its peak memory and
             ``generate`` (batch 4, prompt 512, 16 tokens); then slots
             3-5 (mamba, mamba + MoE, attention) at fp32, prefill and
             256 decode steps held to ``forward_train`` (rtol 1e-4, atol
             4e-4) with capacity C = T.  (m4) every architecture at
             ``reduced()``: the same weights on the card and the CPU
             give logits within 1e-4, and a greedy ``generate`` of 8
             tokens runs on the card.
12. training — the training path (``optim``, ``train``, ``ft``,
             ``launch/train.py``): two AdamW steps of longformer-1.4b at
             full width (fp32, batch 1, S = 4096, remat full), the second
             timed by CUDA events around its forward, backward and
             optimizer, with its peak memory and its K6 launches (768:
             every layer in the forward and in each period's recompute),
             no attention plain version, every gradient finite and the
             loss falling on the batch; one rwkv6-1.6b step at S = 1024
             the same way; ``run_training`` on reduced longformer, rwkv6
             and jamba (6 steps, then stopped at 3 and resumed from the
             checkpoint: losses and params bit for bit, under
             deterministic algorithms; the K6 preflight, and for
             longformer the one-chip K8 preflight, counted); one step of
             every architecture at ``reduced()``, card vs CPU.
13. sharded — K8, the sharded path, on a mesh of 4 chips over the one
             card (``ChipMesh(("cuda:0",) * 4)``), in two parts.  After
             ``oracles``, while the SpMM artifacts live: the three sharded
             wrappers against their plain versions (rtol = atol = 1e-5)
             on small fixtures — C {1, 2, 3, 4} x X replicated / row-
             sharded x resident / staged, the default and a 64-entry
             slot, a hot shard (only its chip walks in chunks) and
             matrices that leave chips empty — each one's workspaces,
             gathered through ``inv_perm``, bit-identical to the
             unsharded forward; then ``compile_spmm(a, 128, mesh=...)`` on
             the uniform graph (defaults: ``pallas_bcsr``, ``dma``,
             ``x_sharding`` ``"replicated"``, as on any mesh whose chips
             share one device; and ``"rows"``, ``resident``,
             ``pallas_ell``) and the banded stencil: 4 launches and the
             reference's dispatch counts a forward, each output bit-
             identical to the unsharded forward, dvals and dX of the
             default and the rows artifact bit-identical to the grad
             phase's, the wrappers timed with their
             exchange, each chip's kernel, the forwards, the plain version
             and ``torch.sparse.mm`` beside K8's bound and the peak
             memory.  After ``attention``: ``compile_sparse_attention`` on
             the longformer mask over the same mesh, 4 K6 launches, bit-
             identical to the unsharded default forward, timed the same
             way.
14. serve  — after the sharded SpMM part, the serving tier at tenant
             sizes (``launch/serve.py``): four seeded tenants in two
             d-buckets — arxiv (ogbn-arxiv's 169,343 nodes, 1.17 M
             edges, d 128), web (power-law, 2^17 rows, 16 a row, d 100),
             stencil (32-wide band, 2^18 rows, d 64), fem27 (27-wide
             band, 2^17 rows, d 40) — served by ``SpmmServer(max_batch=
             4)`` in two rounds (misses, then hits) on the card's
             defaults (``pallas_bcsr``/``dma``: K4), on ``pallas_ell``
             (K3) and with ``staging="resident"`` on both backends (K2,
             K1): one fused launch per two-member chunk (dispatch counts
             and the kernel's launches), every response bit for bit its
             tenant's solo artifact and held to a float64 reference at
             rtol = atol = 1e-4, or, where a row is so long (web's reach
             10,876 nonzeros) that the order of an fp32 sum alone moves
             an element further, within that sum's error bound.  The
             scheduler on manual ticks and on its thread, bit for bit
             round 2; ``compile_spmm(arxiv, 128, autotune=True)`` with
             the CUDA-event measure (each candidate's predicted and each
             finalist's measured ms; the output bit for bit the
             winner's; a second call a pure hit) and an autotuning
             server's batch on the folded knobs; CUDA-event times of
             each bucket's batched forward against its members' solo
             forwards and of the kernel alone, warm rounds' wall time,
             and a ``torch.profiler`` window over a round (idle share,
             the side stream's host-to-device copies and their overlap
             with kernels); device memory falling on ``cache.clear()``
             and on eviction at ``JitCache(capacity=2)`` with no
             ``gc.collect()``.
15. report — the launch counts, one JSON line of per-kernel numbers, and
             the final ``{"ok": true, ...}`` line.

With ``--ab-parent DIR`` (a parent commit unpacked with ``git
archive``) it runs none of the phases above: it imports that tree's
``repro_torch`` beside this one, and times its K1, K2, K5, K6, K7, K9
and K10 wrappers (which build its kernels into ``DIR/build``) beside this
tree's in turns A B B A (CUDA events, medians of 20), each output bit
for bit the parent's: K7 on the uniform graph at d_pad 47 (a direct
call, unplanned), 128, 256 and 1024; K9 on small fixtures at every bm
(each segment also bit for bit K1's rows) and over the uniform graph's
5 segments at bm = 8, summed; K2 on the two 2^20-row instances (also
bit for bit K4); K1 under ``pallas_ell``/``resident`` on both instances
at bm = 8 and on the uniform graph at bm = 1 and 16, with merged trips
(merge_threshold 64), called directly at the unplanned widths 47 and
200 and with a misaligned X (also bit for bit K3); K10 on the banded
stencil's ``BCSRMatrix`` at bm = bk = 8, bm = 16, bk = 1, the unplanned
width 47 and a misaligned X (also bit for bit its plain version); K5
and K6 on the longformer mask
at S = 32768 (both fused backends, and ``pallas_bcsr`` at bm = 16 and at
bk = 1) and at the layer's S = 4096 (all bit for bit the parent's K5),
and K5 on a small mask at the ragged head width 100, at widths where
its ring takes one stage (bm = 16, bk = 32, dh = 1024) or none (dh =
4096, both backends), and with a misaligned K.  With ``--ab-ptxas`` as
well it only prints K1-K7's, K9's and K10's ptxas registers and spills
beside the parent's and fails unless all but K1's and K10's
(redesigned) are the parent's.

With ``--cards 4`` (it exits non-zero, saying so on stderr, unless
four cards are visible) it runs none of the phases above either.  It prints every card's ``nvidia-smi`` name and power limit and
whether each card can reach each other's memory, builds the kernels and
runs, with every chip on a card of its own:
(o1) K8 over ``chip_mesh(4)``: the sharded fixtures (C = 1..4 x X
     replicated/rows x resident/staged), then ``compile_spmm(a, 128,
     mesh=)`` on both 2^20-row instances with the default ``x_sharding``
     (``"rows"``: the exact-panel exchange crosses cards), with
     ``"replicated"`` and on ``pallas_ell``, and
     ``compile_sparse_attention`` on the longformer mask (S = 32768, one
     head): one launch a card a forward (counted by card), each output
     and the default's dvals and dX bit for bit the unsharded forward's,
     the per-chip tables on their cards from compile time on; each
     wrapper, its exchange and the forwards by the host clock with every
     card synchronised, each card's kernel by CUDA events there, the
     bytes ``Tensor.to`` moves between cards, each card's peak, beside
     the same artifact over 4 chips of one card and the unsharded one.
(o2) (l1)'s longformer-1.4b step on ``make_host_mesh(2, 2, cards=4)``
     and on the one-card (2, 2) mesh from the same weights: loss, grad
     norm, parameters and both moments bit for bit; K6 launches by card
     and by chip, bytes gathered a chip a period and moved between cards,
     the model-axis sums, each chip's forward and backward and each
     card's spans (``SplitTally``), each card's busy window on one clock,
     each data group's model chips' backward overlap (at least half the
     shorter chip's) and the two groups', each card's peak, the wall
     time (below the one card's), every host wait with its stack.
(o6) the same on ``make_host_mesh(1, 4, cards=4)`` against the one-card
     (1, 4) mesh at microbatches=2: every model chip off the group's
     card but the first, 384 K6 launches a chip.
(o3) ``run_training`` on reduced longformer at --dp 2 --tp 2 --cards 4,
     uninterrupted and stopped at RUN_STOP, then resumed on
     ``plan_remesh(2, model_parallel=1)`` over ``cuda:0..1``: losses and
     parameters bit for bit the same runs on one card's meshes.
(o4) ``compressed_psum`` over 4 cards, bit for bit over 4 chips of one
     card.
(o5) matmuls on ``cuda:0`` then ``cuda:1``, with and without a 4-byte
     copy between them: whether a copy between cards orders their work.
A part that fails is printed and the next part runs; the run then exits
non-zero with no result line.  It ends with K8's JSON line (its three
wrappers' launches over the cards) and the default run's last line.

It writes nothing into the repo but the kernel builds under ``build/``.
"""
from __future__ import annotations

import argparse
import collections
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
N_MAIN = 2 ** 20              # rows and columns of the main-path instances
D_MAIN = 128                  # GNN hidden width
REPS = 20

D_IN, CLASSES = 100, 47       # GCN input features and classes
TRAIN_STEPS = 5
LR = 1.0

KERNELS = {
    "spmm_ell_fused": dict(
        source="src/repro_torch/kernels/csrc/spmm_ell_fused.cu",
        replaces="src/repro/kernels/spmm_ell_fused.py:67"),
    "spmm_bcsr_fused": dict(
        source="src/repro_torch/kernels/csrc/spmm_bcsr_fused.cu",
        replaces="src/repro/kernels/spmm_bcsr_fused.py:63"),
    "spmm_ell_fused_staged": dict(
        source="src/repro_torch/kernels/csrc/spmm_ell_fused_staged.cu",
        replaces="src/repro/kernels/spmm_ell_fused.py:99"),
    "spmm_bcsr_fused_staged": dict(
        source="src/repro_torch/kernels/csrc/spmm_bcsr_fused_staged.cu",
        replaces="src/repro/kernels/spmm_bcsr_fused.py:110"),
    "attn_fused": dict(
        source="src/repro_torch/kernels/csrc/attn_fused.cu",
        replaces="src/repro/kernels/attn_fused.py:87"),
    "attn_fused_staged": dict(
        source="src/repro_torch/kernels/csrc/attn_fused_staged.cu",
        replaces="src/repro/kernels/attn_fused.py:158"),
    "sddmm": dict(
        source="src/repro_torch/kernels/csrc/sddmm.cu",
        replaces="src/repro/kernels/sddmm.py:23"),
    "spmm_ell_segment": dict(
        source="src/repro_torch/kernels/csrc/spmm_ell_segment.cu",
        replaces="src/repro/kernels/spmm_csr.py:49"),
    "spmm_bcsr": dict(
        source="src/repro_torch/kernels/csrc/spmm_bcsr.cu",
        replaces="src/repro/kernels/spmm_bcsr.py:31"),
    # K8: one launch of K1-K6 per chip; no device code of its own
    "spmm_ell_fused_sharded": dict(
        source="src/repro_torch/kernels/spmm_ell_fused.py",
        replaces="src/repro/kernels/spmm_ell_fused.py:308"),
    "spmm_bcsr_fused_sharded": dict(
        source="src/repro_torch/kernels/spmm_bcsr_fused.py",
        replaces="src/repro/kernels/spmm_bcsr_fused.py:353"),
    "attn_fused_sharded": dict(
        source="src/repro_torch/kernels/attn_fused.py",
        replaces="src/repro/kernels/attn_fused.py:382"),
}
SPMM_KERNELS = tuple(KERNELS)[:4]
ATTN_KERNELS = tuple(KERNELS)[4:6]
ORACLE_KERNELS = tuple(KERNELS)[6:9]
SHARDED_KERNELS = tuple(KERNELS)[9:]
SHARD_CHIPS = 4               # chips of the sharded phase's mesh, one card

# the longformer-1.4b mask and sattn layer (src/repro_torch/configs/
# longformer_1_4b.py): sequence of the attention op phase, and the
# layer's sequence and batch
ATTN_SEQ = 32768
SATTN_SEQ, SATTN_BATCH = 4096, 1


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs, each
    bracketed by CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mixed_dense(seed: int, m: int = 48, n: int = 64) -> np.ndarray:
    """Dense banded block-rows (tagged MXU) plus 1-2 nnz ragged rows
    (tagged VPU), as in the reference's tests/test_bcsr_fused.py."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    for i in range(16):
        j0 = (i // 8) * 16
        dense[i, j0:j0 + 16] = rng.standard_normal(16)
    for i in range(16, m):
        k = rng.integers(1, 3)
        dense[i, rng.choice(n, size=k, replace=False)] = rng.standard_normal(k)
    return dense


def card_line(index: int = 0) -> str:
    """nvidia-smi's own line for card ``index``: its name and power
    limit."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_device() -> None:
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), "
                         f"got {cap}")
    log(card_line())    # the card's name, its power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device count {torch.cuda.device_count()}")
    # the GCN's dense products run in full fp32, as the reference's do;
    # TF32 would keep three digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_smem(name: str, bm: int) -> int:
    """The dynamic shared memory at which the build phase asks the card
    for ``name``'s CTAs per SM: the staged SpMM kernels' ring at the
    default 1024-entry slot (bk = 8 for K4), K2's, K10's and K9's X rings
    at bk = 8, 8 and 0, K1's ring at its stage of ``max(8, bm)`` rows,
    the attention kernels' at dh = 128 and bk = 8, K7's at its elements a
    lane (``bm`` there)."""
    from repro_torch.kernels.spmm_ell_fused import (STAGE_CAP, ring_bytes,
                                                    resident_ring_bytes)
    attn = _kernel_module("attn_fused")
    resident = _kernel_module("spmm_bcsr_fused").ring_bytes
    if name == "spmm_bcsr_fused":
        return resident(bm=bm, bk=8)
    if name == "spmm_bcsr":
        return _kernel_module(name).ring_bytes(bm=bm, bk=8)
    if name == "spmm_ell_fused":
        return resident_ring_bytes(bm=bm)
    if name == "spmm_ell_segment":
        return resident(bm=bm, bk=0)
    if name == "spmm_ell_fused_staged":
        return ring_bytes(STAGE_CAP, bm=bm, bk=1)
    if name == "spmm_bcsr_fused_staged":
        return ring_bytes(STAGE_CAP, bm=bm, bk=8)
    if name == "attn_fused":
        return attn.resident_ring_bytes(bm=bm, bk=8, dh_pad=128)
    if name == "attn_fused_staged":
        return attn.ring_bytes(STAGE_CAP, bm=bm, bk=8, dh_pad=128)
    if name == "sddmm":
        return _kernel_module(name).ring_bytes(bm)
    return 0


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall; per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name, text in _build.BUILD_LOG.items():
        # per template instance, and the CTAs per SM the card reports
        report = []
        for inst, bm, regs, spill in ptxas_lines(text):
            if inst.startswith(NARROW_BODIES):
                # K1's and K10's one-thread-a-column route, in the CTAs
                # of d_pad 47 and 200
                threads = [_kernel_module(name).narrow_threads(d)
                           for d in (47, 200)]
                ctas = [_build.ctas_per_sm(name, bm, 0, threads=t)
                        for t in threads]
                report.append(f"{inst}: {regs} registers, {spill}, "
                              f"{ctas[0]} CTAs/SM of {threads[0]} threads, "
                              f"{ctas[1]} of {threads[1]}")
                continue
            smem = build_smem(name, bm)
            ctas = _build.ctas_per_sm(name, bm, smem)
            report.append(f"{inst}: {regs} registers, {spill}, {ctas} "
                          f"CTAs/SM at {smem} B of dynamic shared memory")
        log(f"ptxas {name}: " + "; ".join(report))


# the kernel bodies of K1's and K10's route at unplanned widths, one
# thread a column
NARROW_BODIES = ("spmm_ell_fused_kernel", "spmm_bcsr_kernel")


def entry_name(mangled: str) -> str:
    """The unqualified name in a mangled kernel name:
    ``_ZN9spmm_ring13gather_kernelILi8E...`` gives ``gather_kernel``."""
    rest, name = mangled[2:].lstrip("N"), mangled
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        end = len(digits) + int(digits)
        name, rest = rest[len(digits):end], rest[end:]
    return name


def ptxas_lines(text: str) -> list:
    """ptxas -v's report in an nvcc log: (instance, arg, registers,
    spills) per kernel instance, the instance named by its kernel and
    its integer and bool template arguments, the first of which is
    ``arg`` (bm; K7's elements a lane)."""
    lines, inst, bm, spill = [], "?", 8, "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mangled = re.search(r"'(_Z\w+)'", line).group(1)
            args = re.findall(r"L[ib](\d+)E", mangled)
            bm = int(args[0]) if args else 8
            inst = (f"{entry_name(mangled)}<{','.join(args)}>" if args
                    else entry_name(mangled))
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            lines.append((inst, bm, regs, spill))
    return lines


def hub_dense(n: int = 8000, m: int = 64, seed: int = 2) -> np.ndarray:
    """A hub row over all n columns plus 1-2 nonzeros a row: the hub's
    trip window (8 rows x n slots, 256 KB at n = 8000) exceeds both the
    staging slot and a CTA's shared memory."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    dense[5] = rng.standard_normal(n)
    for i in range(m):
        k = rng.integers(1, 3)
        dense[i, rng.choice(n, size=k, replace=False)] = rng.standard_normal(k)
    return dense


def block_row_dense(n: int = 8000, m: int = 40, seed: int = 3) -> np.ndarray:
    """A dense 8-row block-row over n columns (tagged MXU; 1000 block
    steps, a 256 KB window) plus a sparse tail of VPU rows."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((m, n), np.float32)
    dense[8:16] = rng.standard_normal((8, n))
    for i in range(m):
        if not 8 <= i < 16:
            dense[i, rng.choice(n, size=2, replace=False)] = (
                rng.standard_normal(2))
    return dense


def kernel_pair(backend: str, staging: str):
    """(name, kernel, plain version) serving ``backend`` under
    ``staging``."""
    from repro_torch import kernels
    name = "spmm_ell_fused" if backend == "pallas_ell" else "spmm_bcsr_fused"
    if staging == "dma":
        name += "_staged"
    return name, getattr(kernels, name), getattr(kernels, name + "_plain")


def windows(c) -> dict:
    return dict(span=c.workspace.max_span, cspan=c.workspace.max_cspan)


def phase_kernels() -> None:
    from repro_torch.core import CSRMatrix, JitCache, compile_spmm, random_csr
    from repro_torch.core.plan import MXU_TAG
    from repro_torch.kernels.spmm_ell_fused import staged_walk, staging_geometry
    small = (16, 100, 128, 640)
    # name -> (instance, d values, staging slot caps, row blocks); at
    # bm = 2 the value windows start off the 16-byte grid
    fixtures = {
        "mixed": (CSRMatrix.from_dense(mixed_dense(0)), small, (None, 64),
                  (8, 2)),
        "empty_rows": (random_csr(300, 256, density=0.03, family="powerlaw",
                                  seed=1), small, (None, 64), (8,)),
        "empty_matrix": (CSRMatrix.from_dense(np.zeros((64, 96), np.float32)),
                         small, (None,), (8,)),
        # windows over the slot and over shared memory; the 8192-entry
        # slot takes a ring over 48 KB of dynamic shared memory
        "hub_row": (CSRMatrix.from_dense(hub_dense()), (128, 640),
                    (None, 8192), (8,)),
        "mxu_block_row": (CSRMatrix.from_dense(block_row_dense()),
                          (128, 640), (None, 8192), (8,)),
    }
    # an 8000-term row summed in order differs from the dense product's
    # blocked sum by more than 1e-4, so the forwards of the long-row
    # fixtures are held to the kernels' plain versions (same order) only
    long_rows = ("hub_row", "mxu_block_row")
    assert np.any(fixtures["empty_rows"][0].row_lengths == 0)
    assert fixtures["empty_matrix"][0].nnz == 0
    seen = dict(merged=False, mxu=False, pad_blocks=False,
                chunked_vpu=False, chunked_mxu=False, unaligned=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    t_sweep = time.perf_counter()
    for (fname, (a, ds, caps, bms)), backend in itertools.product(
            fixtures.items(), ("pallas_ell", "pallas_bcsr")):
        name, kernel, plain = kernel_pair(backend, "resident")
        sname, staged, splain = kernel_pair(backend, "dma")
        worst = worst_staged = 0.0
        configs = 0
        for strategy, mt, d, bm in covering(fname, backend,
                                            fixtures[fname]):
            c = compile_spmm(a, d, strategy=strategy, backend=backend,
                             merge_threshold=mt, staging="resident", bm=bm,
                             validate="full", cache=JitCache())
            ws = c.workspace
            seen["unaligned"] |= bool(np.any(ws.blk_off % 4))
            seen["merged"] |= ws.merge_width > 1
            seen["mxu"] |= bool(np.any(ws.blk_tag == MXU_TAG))
            seen["pad_blocks"] |= bool(np.any(ws.blk_L == 0))
            x = torch.randn(a.n, d, device="cuda", generator=gen)
            operands, knobs = c.fused_operands(a.vals, x)
            got = kernel(*operands, **knobs)
            want = plain(*operands, **knobs)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            # the same sums in one order
            assert torch.equal(got, want), (fname, strategy, mt, d, bm)
            worst = max(worst, (got - want).abs().max().item())
            if fname not in long_rows:
                y = c(a.vals, x)
                ref = a.to_dense().float() @ x
                torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
            configs += 1
            if ws.max_span == 0:       # no descriptors: nothing to stage
                continue
            tables = [torch.from_numpy(t).long() for t in
                      (ws.blk_tag, ws.blk_off, ws.blk_coff, ws.blk_L)]
            for cap in caps:
                if cap == 8192 and d != 128:
                    continue
                kw = dict(knobs, **windows(c), cap=cap)
                got_s = staged(*operands, **kw)
                want_s = splain(*operands, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got_s, want_s, rtol=1e-5,
                                           atol=1e-5)
                assert torch.equal(got_s, got), (fname, backend, strategy,
                                                 mt, d, cap)
                worst_staged = max(worst_staged,
                                   (got_s - want_s).abs().max().item())
                geo = staging_geometry(ws.max_span, ws.max_cspan, bm=c.bm,
                                       bk=c.bk, cap=cap)
                kinds = {it[0] for it in staged_walk(
                    *tables, bm=c.bm, bk=c.bk, mw=ws.merge_width, c=geo[0],
                    ch=geo[1], kc=geo[2])}
                if fname in long_rows:
                    seen["chunked_vpu"] |= "vpu" in kinds
                    seen["chunked_mxu"] |= "mxu" in kinds
        log(f"kernel vs plain: {name} on {fname}: {configs} configurations, "
            f"max |kernel - plain| = {worst:.3g}; {sname}: max |kernel - "
            f"plain| = {worst_staged:.3g}, bit-identical to {name} "
            f"(rtol = atol = 1e-5)")
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise SystemExit(f"chip_smoke: kernel fixtures never reached "
                         f"{missing}")
    log(f"kernels: fixture sweep {time.perf_counter() - t_sweep:.1f} s")
    t_routes = time.perf_counter()
    k1_routes()
    log(f"kernels: K1 routes {time.perf_counter() - t_routes:.1f} s")


# the long-row fixtures' one configuration per backend (strategy,
# merge_threshold, d): each fixture takes both widths and its two
# backends two strategies; the 8192-entry slot runs at d = 128 on each
LONG_ROW_CASES = {
    ("hub_row", "pallas_ell"): ("row_split", 0, 128),
    ("hub_row", "pallas_bcsr"): ("nnz_split", 16, 640),
    ("mxu_block_row", "pallas_ell"): ("merge_split", 16, 640),
    ("mxu_block_row", "pallas_bcsr"): ("row_split", 0, 128),
}


def covering(fname: str, backend: str, fixture) -> list:
    """The fixture sweep's configurations, a covering subset of the full
    product (strategies x merge_threshold {0, 16} x widths x row blocks,
    240 configurations over the fixtures and backends, each bit for bit
    in earlier runs), which keeps the phase's time for the model phase.
    On the short-row fixtures every strategy x threshold pair once, the
    widths and row blocks in turn beside them, so each strategy meets
    every row block and both thresholds and each width comes up.  The
    long-row fixtures, whose 8000-entry windows make a configuration
    cost seconds (the plain versions' chunked walks), take one each
    (:data:`LONG_ROW_CASES`)."""
    from repro_torch.core.plan import STRATEGIES
    _, ds, _, bms = fixture
    if (fname, backend) in LONG_ROW_CASES:
        return [LONG_ROW_CASES[fname, backend] + (bms[0],)]
    pairs = itertools.product(STRATEGIES, (0, 16))
    return [(strategy, mt, ds[i % len(ds)], bms[i % len(bms)])
            for i, (strategy, mt) in enumerate(pairs)]


def k1_routes() -> None:
    """K1 called directly at a width of each route (47 and 200: the
    one-thread-a-column body, width-fitted below 128; 128: the gather
    ring) at every supported bm, with merged trips and without, each
    output bit for bit its plain version and K3's (X padded to whole
    column tiles for K3)."""
    from repro_torch import kernels
    from repro_torch.core import CSRMatrix, JitCache, compile_spmm, random_csr
    k1 = _kernel_module("spmm_ell_fused")
    fixtures = {
        "mixed": CSRMatrix.from_dense(mixed_dense(0)),
        "empty_rows": random_csr(300, 256, density=0.03, family="powerlaw",
                                 seed=1),
    }
    gen = torch.Generator(device="cuda").manual_seed(11)
    routes = {}
    for (fname, a), bm, mt, width in itertools.product(
            fixtures.items(), k1.SUPPORTED_BM, (0, 16), (47, 128, 200)):
        c = compile_spmm(a, 20, backend="pallas_ell", staging="resident",
                         bm=bm, merge_threshold=mt, cache=JitCache())
        ops, knobs = c.fused_operands(a.vals, torch.zeros(a.n, 20,
                                                          device="cuda"))
        x = torch.randn(ops[4].shape[0], width, device="cuda", generator=gen)
        x3 = torch.nn.functional.pad(x, (0, -(-width // 128) * 128 - width))
        got = kernels.spmm_ell_fused(*ops[:4], x, **knobs)
        want = kernels.spmm_ell_fused_plain(*ops[:4], x, **knobs)
        y3 = kernels.spmm_ell_fused_staged(*ops[:4], x3, **knobs,
                                           **windows(c))
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(y3[:, :width], got)):
            raise SystemExit(f"chip_smoke: K1 differs from its plain version "
                             f"or K3 ({fname}, bm = {bm}, merge_threshold "
                             f"{mt}, d_pad {width})")
        route = ("ring" if k1.ring_route(width) else
                 f"narrow, {k1.narrow_threads(width)} threads")
        routes[route] = routes.get(route, 0) + 1
    log(f"K1 routes, direct calls at d_pad 47, 128, 200 x bm "
        f"{k1.SUPPORTED_BM} x merge_threshold {{0, 16}}: cases by route "
        f"{routes}, each bit-identical to the plain version and to K3")
    if len(routes) != 3:
        raise SystemExit(f"chip_smoke: K1's routes not all reached: {routes}")


def bound(operands, out_elems: int, vpu_slots: int, mxu_macs_per_col: int,
          d_pad: int, gathered: int = 0):
    """The least time the card could take for the launch: each input
    byte read once and the output written once over the HBM rate, or the
    fp32 operations these inputs need over the fp32 rate — the larger.
    ``gathered`` adds the bytes of the rows read from an operand that is
    not listed, where the launch touches only some of them."""
    nbytes = sum(t.numel() * t.element_size() for t in operands) + gathered
    nbytes += out_elems * 4
    flops = 2.0 * (vpu_slots + mxu_macs_per_col) * d_pad
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sparse_csr(a):
    """``a`` as a torch CSR tensor on the card (the library yardsticks)."""
    crow = torch.from_numpy(a.row_ptr).cuda()
    col = torch.from_numpy(a.col_indices.astype(np.int64)).cuda()
    return torch.sparse_csr_tensor(crow, col, a.vals, size=a.shape,
                                   check_invariants=False)


def gather_models(ws, nnz: int, d_pad: int, bm: int, bk: int) -> dict:
    """The two gather models of a workspace, in bytes: the slot model
    charges every VPU slot, padding included, one X row from device
    memory; the nnz model charges one X row per nonzero of a VPU row and
    one bk-row X panel per MXU block step (padding slots point at one
    shared column, whose row stays in cache).  Both add each slot's
    value and column and the output once."""
    from repro_torch.core.plan import MXU_TAG
    mxu = ws.blk_tag == MXU_TAG
    L = ws.blk_L.astype(np.int64)
    vpu_slots = int(bm * L[~mxu].sum())
    mxu_steps = int(L[mxu].sum())
    row = 4 * d_pad
    # the VPU descriptors' slots, and how many of them hold a nonzero
    # (a padding slot gathers the sentinel value, index nnz)
    lens = bm * L[~mxu]
    starts = ws.blk_off.astype(np.int64)[~mxu]
    first = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                      lens)
    slots = first + np.arange(vpu_slots, dtype=np.int64)
    vpu_nnz = int(np.count_nonzero(ws.gather_flat[slots] != nnz))
    out = ws.num_blocks * bm * d_pad * 4
    common = vpu_slots * 8 + mxu_steps * (bm * bk * 4 + 4) + out
    return dict(slot=vpu_slots * row + common,
                nnz=vpu_nnz * row + mxu_steps * bk * row + common,
                vpu_slots=vpu_slots, vpu_nnz=vpu_nnz, mxu_steps=mxu_steps)


def launch_ctas(c, name: str) -> int:
    """CTAs per SM the card fits for ``c``'s kernel launch (the staged
    kernels' ring at this workspace's slot, K2's and K1's X rings)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmm_ell_fused import ring_bytes, staging_geometry
    smem = 0
    if name == "spmm_bcsr_fused":
        smem = _kernel_module(name).ring_bytes(bm=c.bm, bk=c.bk)
    if name == "spmm_ell_fused":
        smem = _kernel_module(name).resident_ring_bytes(bm=c.bm)
    if c.staging == "dma":
        ws = c.workspace
        bk = c.bk if c.backend == "pallas_bcsr" else 1
        cap = staging_geometry(ws.max_span, ws.max_cspan, bm=c.bm, bk=bk)[0]
        smem = ring_bytes(cap, bm=c.bm, bk=bk)
    return _build.ctas_per_sm(name, c.bm, smem)


def measure(c, a, x, label: str) -> dict:
    """Hold the kernel to its plain version at size, time the forward,
    the kernel, the plain version and torch.sparse.mm, print them with
    the bounds, the gather models and the achieved rate on the nnz
    model, and return the kernel's row of the JSON report."""
    from repro_torch.core.plan import MXU_TAG
    name, kernel, plain = kernel_pair(c.backend, c.staging)
    operands, knobs = c.fused_operands(a.vals, x)
    if c.staging == "dma":
        knobs.update(windows(c))
    got = kernel(*operands, **knobs)
    want = plain(*operands, **knobs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if name in ("spmm_bcsr_fused", "spmm_ell_fused"):
        assert torch.equal(got, want), (label, name)
    err = (got - want).abs().max().item()
    del got, want
    ws = c.workspace
    bm, bk, d_pad = c.bm, c.bk, int(operands[-1].shape[1])
    mxu = ws.blk_tag == MXU_TAG
    L = ws.blk_L.astype(np.int64)
    vpu_slots = int(bm * L[~mxu].sum())
    mxu_macs = int(bm * bk * L[mxu].sum())
    out_elems = ws.num_blocks * bm * d_pad
    bound_ms, bound_by = bound(operands, out_elems, vpu_slots, mxu_macs,
                               d_pad)
    models = gather_models(ws, a.nnz, d_pad, bm, bk)
    slot_ms = models["slot"] / HBM_BYTES_PER_S * 1e3
    nnz_model_ms = models["nnz"] / HBM_BYTES_PER_S * 1e3
    pad = (1 - models["vpu_nnz"] / models["vpu_slots"]
           if models["vpu_slots"] else 0.0)
    # the structure's own floor, whatever the workspace: A's values and
    # columns (f32 + i32 per nonzero), X read once, Y written once; the
    # workspace bound above also pays for ELL and block padding
    nnz_ms = (a.nnz * 8 + (a.n + a.m) * x.shape[1] * 4) \
        / HBM_BYTES_PER_S * 1e3
    a_sparse = _sparse_csr(a)
    fwd_ms = time_ms(lambda: c(a.vals, x))
    ms = time_ms(lambda: kernel(*operands, **knobs))
    plain_ms = time_ms(lambda: plain(*operands, **knobs), reps=5)
    library_ms = time_ms(lambda: torch.sparse.mm(a_sparse, x))
    log(f"{label}/{c.backend}/{c.staging}: {name} kernel {ms:.4f} ms, "
        f"forward {fwd_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), nnz bound {nnz_ms:.4f} ms, gather model "
        f"{slot_ms:.4f} ms (every slot), nnz gather model "
        f"{nnz_model_ms:.4f} ms ({100 * pad:.1f} % of the VPU slots are "
        f"padding), achieved {models['nnz'] / ms / 1e9:.4f} TB/s on the "
        f"nnz model ({models['nnz'] / 1e9:.4f} GB) against "
        f"{HBM_BYTES_PER_S / 1e12:.2f}; {launch_ctas(c, name)} CTAs/SM; "
        f"max |kernel - plain| {err:.3g}; B={ws.num_blocks} "
        f"mw={ws.merge_width} slots={vpu_slots} "
        f"mxu_blocks={models['mxu_steps']} d_pad={d_pad} "
        f"max_span={ws.max_span}")
    return dict(name=name, route="cuda", **KERNELS[name], max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def make_instances() -> dict:
    from repro_torch.core import random_csr
    instances = {}
    for label, family, per_row in (("uniform", "uniform", 16),
                                   ("banded", "banded", 32)):
        t0 = time.perf_counter()
        a = random_csr(N_MAIN, N_MAIN, density=per_row / N_MAIN,
                       family=family, seed=0)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(N_MAIN, D_MAIN, device="cuda", generator=gen)
        log(f"{label}: m = n = {N_MAIN}, nnz = {a.nnz}, d = {D_MAIN}; "
            f"random_csr {time.perf_counter() - t0:.2f} s")
        instances[label] = (a, x)
    return instances


def phase_main(instances: dict, cache) -> tuple:
    from repro_torch import kernels
    from repro_torch.core import compile_spmm
    from repro_torch.core.plan import MXU_TAG, VPU_TAG
    from repro_torch.kernels import ops

    compiled = {}
    for (label, backend), staging in itertools.product(
            (("uniform", "auto"), ("banded", "auto"),
             ("uniform", "pallas_ell")), (None, "resident")):
        a, _ = instances[label]
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        c = compile_spmm(a, D_MAIN, backend=backend, staging=staging,
                         cache=cache)
        wall = time.perf_counter() - t0
        log(f"{label}/{c.backend}/{c.staging}: compile_spmm {wall:.2f} s "
            f"(plan {ops.BUILD_SECONDS['plan']:.2f} s, pack "
            f"{ops.BUILD_SECONDS['pack']:.2f} s, validate={c.validate})")
        compiled[(label, backend, staging)] = c
    for key, c in compiled.items():
        # the default compile takes the staged kernels on the card
        assert c.staging == ("dma" if key[2] is None else "resident"), key
    tags = {label: compiled[(label, "auto", None)].workspace.blk_tag
            for label in ("uniform", "banded")}
    assert compiled[("uniform", "auto", None)].backend == "pallas_bcsr"
    assert np.any(tags["uniform"] == VPU_TAG), "uniform must run VPU trips"
    assert np.any(tags["banded"] == MXU_TAG), "banded must run MXU trips"

    # the main path, counted: every count is zeroed just before and read
    # just after; each forward is one dispatch and one launch
    for name in SPMM_KERNELS:
        getattr(kernels, name).launches = 0
    outputs = {}
    for key, c in compiled.items():
        a, x = instances[key[0]]
        name, kernel, _ = kernel_pair(c.backend, c.staging)
        ops.reset_dispatch_counts()
        before = kernel.launches
        outputs[key] = c(a.vals, x)
        dispatch = "bcsr_fused" if c.backend == "pallas_bcsr" else "ell_fused"
        assert ops.DISPATCH_COUNTS[dispatch] == 1, dict(ops.DISPATCH_COUNTS)
        assert ops.DISPATCH_COUNTS[dispatch + "_dma"] == (
            c.staging == "dma"), dict(ops.DISPATCH_COUNTS)
        assert kernel.launches == before + 1, (name, kernel.launches)
    torch.cuda.synchronize()
    launches = {name: getattr(kernels, name).launches
                for name in SPMM_KERNELS}
    log(f"main path launches: {launches}")

    for key, y in outputs.items():
        a, x = instances[key[0]]
        c = compiled[key]
        assert y.shape == (a.m, D_MAIN) and bool(torch.isfinite(y).all())
        ref = compile_spmm(a, D_MAIN, backend="ref", cache=cache)(a.vals, x)
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
        line = (f"{key[0]}/{c.backend}/{c.staging}: forward matches ref, "
                f"max |y - ref| = {(y - ref).abs().max().item():.3g} "
                f"(rtol = atol = 1e-4)")
        if c.staging == "dma":
            assert torch.equal(y, outputs[key[:2] + ("resident",)]), key
            line += ", bit-identical to the resident forward"
        log(line)
        del ref
    del outputs
    torch.cuda.empty_cache()

    # the report's rows: K1/K3 on the uniform graph, K2/K4 on the banded
    # stencil; K2/K4 on the uniform graph are printed beside them
    results = {}
    for staging in ("resident", None):
        ell = measure(compiled[("uniform", "pallas_ell", staging)],
                      *instances["uniform"], "uniform")
        bcsr = measure(compiled[("banded", "auto", staging)],
                       *instances["banded"], "banded")
        measure(compiled[("uniform", "auto", staging)],
                *instances["uniform"], "uniform")
        results[ell["name"]] = ell
        results[bcsr["name"]] = bcsr
    for name, row in results.items():
        row["launches"] = launches[name]
    profile_forward(compiled[("uniform", "auto", None)],
                    *instances["uniform"])
    return results, compiled


def profile_forward(c, a, x, forwards: int = 2) -> None:
    """One torch.profiler window over ``forwards`` default forwards on
    the uniform graph: device time by kernel (``key_averages()``) and
    the device's idle share of the window, the span from the first to
    the last event the profiler recorded, host or device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    c(a.vals, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            c(a.vals, x)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.time_range.end > e.time_range.start]
    if not device:
        log(f"profile: torch.profiler recorded no device time over "
            f"{forwards} default forwards; the CUDA-event split above "
            f"stands")
        return
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy, reach = 0.0, start
    for e in sorted(device, key=lambda e: e.time_range.start):
        lo = max(e.time_range.start, reach)
        if e.time_range.end > lo:
            busy += e.time_range.end - lo
            reach = e.time_range.end
    rows = []
    for row in prof.key_averages():
        t = getattr(row, "self_device_time_total", None)
        if t is None:
            t = getattr(row, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t, row.count, row.key))
    rows.sort(reverse=True)
    log(f"profile: {forwards} default forwards on the uniform graph "
        f"({c.backend}/{c.staging}): window {(end - start) / 1e3:.4f} ms, "
        f"device busy {busy / 1e3:.4f} ms, idle share "
        f"{100 * (1 - busy / (end - start)):.1f} %; device ms by kernel: "
        + "; ".join(f"{key[:60]} x{count} {t / 1e3:.4f}"
                    for t, count, key in rows[:8]))


def gcn_graph(a):
    """The uniform graph plus self-loops, sym-normalised as
    examples/gnn_graphconv.py normalises its graph, built with
    ``from_coo``."""
    from repro_torch.core import from_coo
    n = a.m
    rows = np.concatenate([np.repeat(np.arange(n), a.row_lengths),
                           np.arange(n)])
    cols = np.concatenate([a.col_indices, np.arange(n, dtype=np.int32)])
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    vals = (1.0 / np.sqrt(deg[rows] * deg[cols])).astype(np.float32)
    return from_coo((n, n), rows, cols, vals)


def phase_train(a, cache) -> dict:
    """Five SGD steps of the GCN on the uniform graph plus self-loops,
    through the default (staged) artifacts; step 0 held to ``ref``."""
    from repro_torch import gnn
    from repro_torch.core import compile_spmm
    from repro_torch.kernels import ops, spmm_bcsr_fused_staged as k4

    t0 = time.perf_counter()
    a_hat = gcn_graph(a)
    log(f"train: graph {a_hat.m} nodes, {a_hat.nnz} edges incl. self-loops "
        f"(from_coo {time.perf_counter() - t0:.2f} s)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    feats = torch.randn(a_hat.m, D_IN, device="cuda", generator=gen)
    w_star = torch.randn(D_IN, CLASSES, device="cuda", generator=gen)
    planted = compile_spmm(a_hat, D_IN, backend="ref", cache=cache)
    labels = (planted(a_hat.vals, feats) @ w_star).argmax(-1)
    params = {"w1": torch.randn(D_IN, D_MAIN, device="cuda",
                                generator=gen) * 0.1,
              "w2": torch.randn(D_MAIN, CLASSES, device="cuda",
                                generator=gen) * 0.1}
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    t0 = time.perf_counter()
    aggs = [compile_spmm(a_hat, d, cache=cache) for d in (D_MAIN, CLASSES)]
    log(f"train: compile_spmm x2 {time.perf_counter() - t0:.2f} s "
        f"({aggs[0].backend}, staging {aggs[0].staging})")
    assert all(c.backend == "pallas_bcsr" and c.staging == "dma"
               for c in aggs)

    # step 0's gradients through the ref backend, on copies of the weights
    refs = [compile_spmm(a_hat, d, backend="ref", cache=cache)
            for d in (D_MAIN, CLASSES)]
    ref_params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
    gnn.gcn_loss(ref_params, *refs, a_hat.vals, feats, labels).backward()

    losses, step_ms = [], []
    for step in range(TRAIN_STEPS + 1):
        before = k4.launches
        ops.reset_dispatch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = gnn.gcn_loss(params, *aggs, a_hat.vals, feats, labels)
        if step < TRAIN_STEPS:
            loss.backward()
            if step == 0:
                for k in params:
                    torch.testing.assert_close(
                        params[k].grad, ref_params[k].grad, rtol=1e-4,
                        atol=1e-4)
            gnn.sgd_step(params, LR)
        end.record()
        end.synchronize()
        losses.append(loss.item())
        if step < TRAIN_STEPS:
            step_ms.append(start.elapsed_time(end))
            # two forward aggregations, two dX through the transposes
            assert k4.launches == before + 4, (step, k4.launches - before)
            assert ops.DISPATCH_COUNTS["bcsr_fused_dma"] == 4
    # the constant edge values need no dvals: the SDDMM's row expansion
    # was never built
    assert all(c._rows is None for c in aggs)
    assert all(c._transpose is not None and c._transpose.staging == "dma"
               for c in aggs)
    # a step that learned the edge values would add dvals at each width:
    # K7's at the output width 47, beside the chunked torch SDDMM
    dvals_times(aggs[1], refs[1],
                torch.randn(a_hat.m, CLASSES, device="cuda", generator=gen),
                torch.randn(a_hat.n, CLASSES, device="cuda", generator=gen),
                "the uniform graph plus self-loops")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    log(f"train: losses {', '.join(f'{v:.6f}' for v in losses)}; step 0 "
        f"grads match ref (rtol = atol = 1e-4)")
    # step 0 also built the transposed artifacts; the rest are steady
    log(f"train: step ms (CUDA events) "
        f"{', '.join(f'{v:.4f}' for v in step_ms)}; median of steps 1-"
        f"{TRAIN_STEPS - 1}: {statistics.median(step_ms[1:]):.4f} ms; "
        f"4 staged launches a step")
    return dict(launches=4 * TRAIN_STEPS,
                step_ms=statistics.median(step_ms[1:]))


def dvals_times(c, c_ref, dy, x, label: str) -> None:
    """dvals of the artifact ``c`` (K7 over its cached pairs) beside the
    chunked torch SDDMM that the ``ref`` artifact ``c_ref`` keeps (the
    form every backend's dvals took before K7), on the same dY and X,
    held to each other at 1e-4; fails unless K7's is the faster."""
    k7 = c._sddmm(dy, x)
    chunked = c_ref._sddmm(dy, x)
    torch.testing.assert_close(k7, chunked, rtol=1e-4, atol=1e-4)
    t_k7 = time_ms(lambda: c._sddmm(dy, x))
    t_chunked = time_ms(lambda: c_ref._sddmm(dy, x))
    log(f"grad: dvals on {label}, d = {x.shape[1]}: K7 {t_k7:.4f} ms, the "
        f"chunked torch SDDMM {t_chunked:.4f} ms (max |diff| "
        f"{(k7 - chunked).abs().max().item():.3g})")
    if not t_k7 < t_chunked:
        raise SystemExit(f"chip_smoke: dvals through K7 are not faster "
                         f"than the chunked SDDMM on {label}")


def phase_grad(c, a, x, cache) -> tuple:
    """dvals and dX through the default artifact at size, held to ref
    (dvals: K7 against the ref backend's chunked torch SDDMM); the one
    K7 launch of the backward, counted; dvals timed beside the chunked
    form.  Returns G (the output gradient), both dvals, dX and the K7
    launches."""
    from repro_torch import kernels
    from repro_torch.core import compile_spmm
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn(a.m, D_MAIN, device="cuda", generator=gen)
    c_ref = compile_spmm(a, D_MAIN, backend="ref", cache=cache)
    grads = []
    for art in (c, c_ref):
        vals = a.vals.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        kernels.sddmm.launches = 0
        (art(vals, xx) * g).sum().backward()
        torch.cuda.synchronize()
        grads.append((vals.grad, xx.grad, kernels.sddmm.launches))
    (dv, dx, launches), (dv_ref, dx_ref, ref_launches) = grads
    assert (launches, ref_launches) == (1, 0), (launches, ref_launches)
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-4)
    log(f"grad: {c.backend}/{c.staging} dvals (K7, {launches} launch) max "
        f"|diff| {(dv - dv_ref).abs().max().item():.3g}, dX max |diff| "
        f"{(dx - dx_ref).abs().max().item():.3g} vs ref "
        f"(rtol = atol = 1e-4)")
    dvals_times(c, c_ref, g, x, "the uniform graph")
    return g, dv, dv_ref, dx, launches


# -- the SDDMM and the micro-oracles: K7, K9, K10 ----------------------------

def _kernel_module(name: str):
    """The module ``repro_torch.kernels.<name>`` (the package exports
    some kernels' functions under their modules' names)."""
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{name}")


def phase_oracle_fixtures() -> None:
    """K7, K9 and K10 against their plain versions on small fixtures."""
    from repro_torch.core import BCSRMatrix, CSRMatrix, random_csr
    from repro_torch.core.plan import STRATEGIES, build_plan
    from repro_torch.kernels import (sddmm, sddmm_csr, sddmm_plain, spmm_bcsr,
                                     spmm_bcsr_plain, spmm_ell_segment,
                                     spmm_ell_segment_plain)
    from repro_torch.kernels.spmm_ell_fused import SUPPORTED_BM
    k7, k10 = _kernel_module("sddmm"), _kernel_module("spmm_bcsr")
    fixtures = {
        "mixed": CSRMatrix.from_dense(mixed_dense(0)),
        "empty_rows": random_csr(300, 256, density=0.03, family="powerlaw",
                                 seed=1),
        "empty_matrix": CSRMatrix.from_dense(np.zeros((64, 96), np.float32)),
        "banded": random_csr(64, 64, density=0.1, family="banded", seed=2),
    }
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = dict.fromkeys(ORACLE_KERNELS, 0.0)
    configs = dict.fromkeys(ORACLE_KERNELS, 0)
    seen = dict(ragged_pairs=False, no_pairs=False, two_tiles=False,
                unplanned_width=False, empty_segment=False,
                padded_block_rows=False, k10_routes=False)

    def check(name, got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if got.numel():
            worst[name] = max(worst[name], (got - want).abs().max().item())
        configs[name] += 1

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    sparse = ("mixed", "empty_rows", "empty_matrix")
    for fname, T, d in itertools.product(sparse, (8, 128), (16, 100, 128,
                                                            640)):
        a = fixtures[fname]
        dy, x = rand(a.m, d), rand(a.n, d)
        before = sddmm.launches
        got = sddmm_csr(a, dy, x, T=T)
        operands = k7._csr_pairs(a, dy, x, T=T, device=str(x.device))
        assert sddmm.launches == before + (a.nnz > 0), (fname, T, d)
        check("sddmm", got, sddmm_plain(*operands, T=T)[:a.nnz])
        seen["ragged_pairs"] |= a.nnz % T != 0
        seen["no_pairs"] |= a.nnz == 0
        seen["two_tiles"] |= operands[3].shape[1] == 1024
    # direct calls at unplanned widths, d_pad = 45 (not a multiple of 4)
    # and 100
    a = fixtures["mixed"]
    for d in (45, 100):
        dy, x = rand(a.m, d), rand(a.n, d)
        rows, cols, _, _ = k7._csr_pairs(a, dy, x, T=8, device=str(x.device))
        check("sddmm", sddmm(rows, cols, dy, x, T=8),
              sddmm_plain(rows, cols, dy, x, T=8))
        seen["unplanned_width"] |= d % 4 != 0
    for fname, strategy, bm in itertools.product(sparse, STRATEGIES,
                                                 (1, 2, 4, 8)):
        a = fixtures[fname]
        plan = build_plan(a.row_ptr, a.col_indices, a.shape, 20,
                          strategy=strategy)
        x = rand(a.n, plan.d_tiling.d_pad)
        vals_ext = torch.cat([a.vals.float(), a.vals.new_zeros(1)])
        for seg in plan.segments:
            cols = torch.from_numpy(seg.cols_pad.reshape(-1)).cuda()
            vals = vals_ext[torch.from_numpy(seg.gather_idx).cuda()]
            check("spmm_ell_segment", spmm_ell_segment(cols, vals, x, bm=bm),
                  spmm_ell_segment_plain(cols, vals, x, bm=bm))
            seen["empty_segment"] |= seg.L == 0
    # K10 on both routes: the ring at d_pad 128, the one-CTA-a-block-row
    # body at 16 and 47 (width-fitted CTAs), at 200 and where the ring
    # does not fit (bk = 128); each bit for bit its plain version
    k10_routes = {}
    k10_cases = list(itertools.product(("mixed", "banded"), (16, 47, 128, 200),
                                       SUPPORTED_BM, (1, 8)))
    for fname, d, bm, bk in k10_cases + [("mixed", 128, 8, 128)]:
        b = BCSRMatrix.from_csr(fixtures[fname], bm, bk)
        cols, vals, kmax = k10._pad_to_kmax(b)
        x = rand(b.shape[1], d)
        got = spmm_bcsr(cols, vals, x, kmax=kmax)
        want = spmm_bcsr_plain(cols, vals, x, kmax=kmax)
        check("spmm_bcsr", got, want)
        if not torch.equal(got, want):
            raise SystemExit(f"chip_smoke: K10 differs from its plain "
                             f"version ({fname}, d {d}, bm {bm}, bk {bk})")
        route = ("ring" if k10.ring_route(d, bm=bm, bk=bk)
                 else "narrow" if d % 128 else "narrow, ring over the CTA")
        k10_routes[route] = k10_routes.get(route, 0) + 1
        seen["padded_block_rows"] |= bool(
            np.any(np.diff(b.block_row_ptr) < kmax))
    log(f"K10 cases by route: {k10_routes}, each bit-identical to the "
        f"plain version")
    seen["k10_routes"] = len(k10_routes) == 3
    log("oracle kernels vs plain (rtol = atol = 1e-5): " + "; ".join(
        f"{name}: {configs[name]} configurations, max |kernel - plain| "
        f"{worst[name]:.3g}" for name in ORACLE_KERNELS))
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise SystemExit(f"chip_smoke: oracle fixtures never reached "
                         f"{missing}")


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary, as ``torch.empty(numel + 1)[1:].view(shape)`` does."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


def phase_misaligned(instances: dict, compiled: dict) -> None:
    """Valid float32 views that start off a 16-byte boundary: the
    default SpMM forward on the uniform graph (X), the default attention
    forward on the layer's mask (K and V, both fused backends), K7 (dY
    and X) and K9 (X) each give bit for bit what the aligned operands
    and ``staging="resident"`` give."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import JitCache, compile_sparse_attention
    from repro_torch.models.sparse_attention import sparse_attention_mask
    a, x = instances["uniform"]
    x_off = misaligned(x)
    y = compiled[("uniform", "auto", None)](a.vals, x)
    same = [torch.equal(compiled[("uniform", "auto", s)](a.vals, x_off), y)
            for s in (None, "resident")]
    del y, x_off
    cfg = get_config("longformer-1.4b")
    mask = sparse_attention_mask(SATTN_SEQ, cfg.sparse_attn_window,
                                 cfg.sparse_attn_global)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(SATTN_SEQ, cfg.head_dim, device="cuda",
                           generator=gen) for _ in range(3))
    k_off, v_off = misaligned(k), misaligned(v)
    for backend in ("pallas_bcsr", "pallas_ell"):
        arts = [compile_sparse_attention(mask, cfg.head_dim, cfg.head_dim,
                                         backend=backend, staging=st,
                                         cache=JitCache())
                for st in (None, "resident")]
        assert arts[0].staging == "dma"
        want = arts[0](mask.vals, q, k, v)
        same += [torch.equal(c(mask.vals, q, k_off, v_off), want)
                 for c in arts]
    k7 = _kernel_module("sddmm")
    g = torch.randn(a.m, D_MAIN, device="cuda", generator=gen)
    rows, cols, _, _ = k7._csr_pairs(a, g, x, device=str(x.device))
    same.append(torch.equal(
        kernels.sddmm(rows, cols, misaligned(g), misaligned(x)),
        kernels.sddmm(rows, cols, g, x)))
    del rows, cols, g
    seg = compiled[("uniform", "pallas_ell", "resident")].plan.segments[-1]
    vals_ext = torch.cat([a.vals.float(), a.vals.new_zeros(1)])
    cols = torch.from_numpy(seg.cols_pad.reshape(-1)).cuda()
    vals = vals_ext[torch.from_numpy(seg.gather_idx).cuda()]
    same.append(torch.equal(kernels.spmm_ell_segment(cols, vals,
                                                     misaligned(x)),
                            kernels.spmm_ell_segment(cols, vals, x)))
    log(f"misaligned operands (data_ptr % 16 = 4), bit-identical to the "
        f"aligned and resident results: SpMM default, resident {same[:2]}; "
        f"attention pallas_bcsr default, resident {same[2:4]}, pallas_ell "
        f"{same[4:6]}; K7 {same[6]}; K9 {same[7]}")
    if not all(same):
        raise SystemExit("chip_smoke: a misaligned operand changed a result")


def phase_oracles(instances: dict, compiled: dict, grad: tuple) -> dict:
    """K7, K9 and K10 at size: the counted run, the checks against the
    fused kernels and the backward, the misaligned operands, and the
    timings."""
    from repro_torch import kernels
    from repro_torch.core import BCSRMatrix
    from repro_torch.kernels import _build, ops
    k7, k10 = _kernel_module("sddmm"), _kernel_module("spmm_bcsr")
    phase_oracle_fixtures()
    phase_misaligned(instances, compiled)

    a, x = instances["uniform"]
    g, dv, dv_ref, _, _ = grad
    c_ell = compiled[("uniform", "pallas_ell", "resident")]
    assert c_ell.plan.strategy == "nnz_split"
    vals_ext = torch.cat([a.vals.float(), a.vals.new_zeros(1)])
    segs = [(torch.from_numpy(s.cols_pad.reshape(-1)).cuda(),
             vals_ext[torch.from_numpy(s.gather_idx).cuda()], s)
            for s in c_ell.plan.segments]
    del vals_ext
    a_b, x_b = instances["banded"]
    t0 = time.perf_counter()
    blocks = BCSRMatrix.from_csr(a_b, 8, 8)
    bcols, bvals, kmax = k10._pad_to_kmax(blocks)
    x_bp = torch.nn.functional.pad(x_b, (0, 0, 0,
                                         blocks.shape[1] - x_b.shape[0]))
    log(f"oracles: BCSRMatrix.from_csr on the banded stencil "
        f"{time.perf_counter() - t0:.2f} s: {blocks.nblocks} blocks of "
        f"8 x 8, kmax {kmax}, {bcols.shape[0] - blocks.nblocks} padding "
        f"blocks; nnz_split plan of the uniform graph: {len(segs)} "
        f"segments, L = {[s.L for _, _, s in segs]}")

    # the path, counted: zeroed just before, read just after
    for name in ORACLE_KERNELS:
        getattr(kernels, name).launches = 0
    ops.reset_dispatch_counts()
    with _PlainCalls(("repro_torch.kernels.sddmm", "sddmm_plain"),
                     ("repro_torch.kernels.spmm_csr",
                      "spmm_ell_segment_plain"),
                     ("repro_torch.kernels.spmm_bcsr",
                      "spmm_bcsr_plain")) as plain:
        dvals = kernels.sddmm_csr(a, g, x)
        seg_out = [ops.spmm_ell_segment_op(cols, vals, x, bm=c_ell.bm)
                   for cols, vals, _ in segs]
        y10 = ops.spmm_bcsr_op(bcols, bvals, x_bp, kmax=kmax)
        torch.cuda.synchronize()
    launches = {name: getattr(kernels, name).launches
                for name in ORACLE_KERNELS}
    log(f"oracles path launches: {launches}; dispatches "
        f"{dict(ops.DISPATCH_COUNTS)}; plain versions run: {plain.calls}")
    assert plain.calls == 0, plain.calls
    assert launches == {"sddmm": 1, "spmm_ell_segment": len(segs),
                        "spmm_bcsr": 1}, launches
    assert dict(ops.DISPATCH_COUNTS) == {
        "sddmm": 1, "ell_segment": len(segs), "bcsr": 1}

    # K7: the backward's dvals (chunked torch SDDMM) and ref's
    assert dvals.shape == (a.nnz,) and bool(torch.isfinite(dvals).all())
    torch.testing.assert_close(dvals, dv, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dvals, dv_ref, rtol=1e-4, atol=1e-4)
    log(f"oracles: sddmm_csr on the uniform graph, d = {D_MAIN}: max "
        f"|diff| {(dvals - dv).abs().max().item():.3g} vs the backward's "
        f"dvals, {(dvals - dv_ref).abs().max().item():.3g} vs ref (rtol = "
        f"atol = 1e-4)")
    del dvals
    # K9: the segments scattered back to their rows against K1's forward
    y9 = torch.zeros((a.m, x.shape[1]), device="cuda")
    for out, (_, _, s) in zip(seg_out, segs):
        y9[torch.from_numpy(s.row_ids).cuda()] = out[:s.R]
    del seg_out
    y1 = c_ell(a.vals, x)
    torch.testing.assert_close(y9, y1, rtol=1e-4, atol=1e-4)
    log(f"oracles: spmm_ell_segment over {len(segs)} segments vs the K1 "
        f"forward: max |diff| {(y9 - y1).abs().max().item():.3g} (rtol = "
        f"atol = 1e-4), bit-identical: {torch.equal(y9, y1)}")
    del y9, y1
    # K10: the banded stencil against K2's forward
    c_b = compiled[("banded", "auto", "resident")]
    y2 = c_b(a_b.vals, x_b)
    y10 = y10[:a_b.m, :D_MAIN]
    torch.testing.assert_close(y10, y2, rtol=1e-4, atol=1e-4)
    log(f"oracles: spmm_bcsr vs the K2 forward: max |diff| "
        f"{(y10 - y2).abs().max().item():.3g} (rtol = atol = 1e-4), "
        f"bit-identical: {torch.equal(y10, y2)}")
    del y10, y2
    torch.cuda.empty_cache()

    rows = {}
    # K7 alone, end to end, in the backward's dvals, the library
    ops7 = k7._csr_pairs(a, g, x, device=str(x.device))
    got = kernels.sddmm(*ops7)
    want = kernels.sddmm_plain(*ops7)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err7 = (got - want).abs().max().item()
    del got, want
    c_default = compiled[("uniform", "auto", None)]
    ms7 = time_ms(lambda: kernels.sddmm(*ops7))
    e2e_ms = time_ms(lambda: kernels.sddmm_csr(a, g, x))
    backward_ms = time_ms(lambda: c_default._sddmm(g, x))
    plain7 = time_ms(lambda: kernels.sddmm_plain(*ops7), reps=5)
    a_sp = _sparse_csr(a)
    xt = x.t()

    def sampled():
        return torch.sparse.sampled_addmm(a_sp, g, xt, beta=0.0)

    lib_diff = (sampled().values() - dv).abs().max().item()
    lib7 = time_ms(sampled)
    nnz_pad, d_pad = ops7[0].shape[0], ops7[3].shape[1]
    nbytes = 12 * nnz_pad + 4 * (a.m + a.n) * d_pad
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nnz_pad * d_pad / FP32_FLOPS_PER_S * 1e3
    bound7, by7 = max((t_bytes, "bytes"), (t_ops, "operations"))
    gather7 = (a.nnz * (4 * d_pad + 12) + 4 * a.m * d_pad) \
        / HBM_BYTES_PER_S * 1e3
    log(f"oracles/uniform: sddmm kernel {ms7:.4f} ms, sddmm_csr end to end "
        f"{e2e_ms:.4f} ms, the backward's dvals (K7 over the artifact's "
        f"pairs) {backward_ms:.4f} ms, plain {plain7:.4f} ms, "
        f"torch.sparse.sampled_addmm {lib7:.4f} ms (max |diff| "
        f"{lib_diff:.3g} vs the backward's dvals), bound {bound7:.4f} ms "
        f"({by7}; operations {t_ops:.4f}), gather model {gather7:.4f} ms, "
        f"max |kernel - plain| {err7:.3g}; nnz_pad = {nnz_pad}, d_pad = "
        f"{d_pad}")
    rows["sddmm"] = dict(ms=ms7, plain_ms=plain7, bound_ms=bound7,
                         bound_by=by7, library_ms=lib7, max_abs_err=err7)
    del ops7, a_sp

    # K9 per segment, beside K1 on the whole plan and the library
    seg_ms, seg_plain, seg_bound, seg_rows, err9 = [], [], [], [], 0.0
    for cols, vals, s in segs:
        got = kernels.spmm_ell_segment(cols, vals, x, bm=c_ell.bm)
        want = kernels.spmm_ell_segment_plain(cols, vals, x, bm=c_ell.bm)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err9 = max(err9, (got - want).abs().max().item())
        del got, want
        seg_ms.append(time_ms(
            lambda: kernels.spmm_ell_segment(cols, vals, x, bm=c_ell.bm)))
        seg_plain.append(time_ms(
            lambda: kernels.spmm_ell_segment_plain(cols, vals, x,
                                                   bm=c_ell.bm), reps=5))
        # X counted by the distinct rows the segment reads, once each
        touched = torch.unique(cols).numel()
        seg_rows.append((vals.shape[0], touched))
        seg_bound.append(bound([cols, vals], vals.shape[0] * x.shape[1],
                               vals.numel(), 0, x.shape[1],
                               gathered=touched * x.shape[1] * 4))
    operands1, knobs1 = c_ell.fused_operands(a.vals, x)
    k1_ms = time_ms(lambda: kernels.spmm_ell_fused(*operands1, **knobs1))
    del operands1
    a_sp = _sparse_csr(a)
    lib9 = time_ms(lambda: torch.sparse.mm(a_sp, x))
    del a_sp
    bound9 = sum(t for t, _ in seg_bound)
    by9 = "bytes" if all(k == "bytes" for _, k in seg_bound) \
        else "operations"
    log(f"oracles/uniform: spmm_ell_segment over {len(segs)} segments "
        f"{sum(seg_ms):.4f} ms in all (largest {max(seg_ms):.4f} ms; "
        f"{', '.join(f'{t:.4f}' for t in seg_ms)}), K1 spmm_ell_fused on "
        f"the whole plan {k1_ms:.4f} ms, torch.sparse.mm {lib9:.4f} ms, "
        f"plain {sum(seg_plain):.4f} ms, bound {bound9:.4f} ms ({by9}, "
        f"the launches' bounds summed: "
        f"{', '.join(f'{t:.4f}' for t, _ in seg_bound)}), max |kernel - "
        f"plain| {err9:.3g}; (R_pad, distinct X rows read) per segment "
        f"{seg_rows}")
    rows["spmm_ell_segment"] = dict(ms=sum(seg_ms), plain_ms=sum(seg_plain),
                                    bound_ms=bound9, bound_by=by9,
                                    library_ms=lib9, max_abs_err=err9)
    del segs

    # K10 beside K2 and the library
    got = kernels.spmm_bcsr(bcols, bvals, x_bp, kmax=kmax)
    want = kernels.spmm_bcsr_plain(bcols, bvals, x_bp, kmax=kmax)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err10 = (got - want).abs().max().item()
    del got, want
    plain10 = time_ms(lambda: kernels.spmm_bcsr_plain(bcols, bvals, x_bp,
                                                      kmax=kmax), reps=5)
    operands2, knobs2 = c_b.fused_operands(a_b.vals, x_b)
    # K10 and K2 in A B B A order
    ms10 = time_ms(lambda: kernels.spmm_bcsr(bcols, bvals, x_bp, kmax=kmax))
    k2_runs = [time_ms(lambda: kernels.spmm_bcsr_fused(*operands2, **knobs2))
               for _ in range(2)]
    ms10_b = time_ms(lambda: kernels.spmm_bcsr(bcols, bvals, x_bp,
                                               kmax=kmax))
    k2_ms = k2_runs[0]
    # the same two kernels through torch.profiler: device time alone,
    # without the launch path that CUDA events also see
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            kernels.spmm_bcsr(bcols, bvals, x_bp, kmax=kmax)
            kernels.spmm_bcsr_fused(*operands2, **knobs2)
        torch.cuda.synchronize()
    # both are the gather ring's kernel: K10 with the BlockRows source,
    # K2 with the resident one
    names = {"spmm_bcsr": ("gather_kernel<", "BlockRows>"),
             "spmm_bcsr_fused": ("gather_kernel<", "Resident>")}
    traced = {tag: [e.device_time_total / e.count / 1e3
                    for e in prof.key_averages()
                    if all(w in e.key for w in words)]
              for tag, words in names.items()}
    if not all(traced.values()):
        raise SystemExit(f"chip_smoke: torch.profiler recorded no launch of "
                         f"K10 or K2: {traced}")
    del operands2
    ws_b = c_b.workspace
    tags_b = np.bincount(ws_b.blk_tag, minlength=2)
    in_order = bool(np.all(np.diff(ws_b.blk_coff) >= 0))
    k2_ctas = launch_ctas(c_b, "spmm_bcsr_fused")
    assert k10.ring_route(D_MAIN, bm=blocks.bm, bk=blocks.bk)
    k10_ctas = _build.ctas_per_sm(
        "spmm_bcsr", blocks.bm, k10.ring_bytes(bm=blocks.bm, bk=blocks.bk))
    a_sp = _sparse_csr(a_b)
    lib10 = time_ms(lambda: torch.sparse.mm(a_sp, x_b))
    del a_sp
    bound10, by10 = bound([bcols, bvals, x_bp], blocks.shape[0] * D_MAIN, 0,
                          bvals.numel(), D_MAIN)
    log(f"oracles/banded: spmm_bcsr kernel {ms10:.4f} ms, K2 "
        f"spmm_bcsr_fused {k2_ms:.4f} ms, torch.sparse.mm {lib10:.4f} ms, "
        f"plain {plain10:.4f} ms, bound {bound10:.4f} ms ({by10}), max "
        f"|kernel - plain| {err10:.3g}; {bcols.shape[0]} block steps")
    log(f"oracles/banded: K10 {ms10:.4f} / {ms10_b:.4f} ms, K2 "
        f"{k2_runs[0]:.4f} / {k2_runs[1]:.4f} ms (A B B A); both on the "
        f"gather ring: K10 persistent CTAs ({k10_ctas} an SM) over "
        f"{blocks.n_block_rows} block-rows of {kmax} block steps, K2 "
        f"persistent CTAs ({k2_ctas} an SM) over "
        f"{ws_b.blk_tag.shape[0] // ws_b.merge_width} trips of "
        f"{ws_b.blk_tag.shape[0]} descriptors (merge width {ws_b.merge_width}; {int(tags_b[0])} "
        f"VPU, {int(tags_b[1])} MXU; block columns in K10's order: "
        f"{in_order}); torch.profiler device ms per launch, mean of "
        f"{REPS}: K10 {traced['spmm_bcsr']}, K2 {traced['spmm_bcsr_fused']}")
    rows["spmm_bcsr"] = dict(ms=ms10, plain_ms=plain10, bound_ms=bound10,
                             bound_by=by10, library_ms=lib10,
                             max_abs_err=err10)
    return {name: dict(name=name, route="cuda", **KERNELS[name],
                       launches=launches[name], **rows[name])
            for name in ORACLE_KERNELS}


# -- the sharded path: K8 on a mesh of chips over one card -------------------

def shard_mesh(chips: int = SHARD_CHIPS):
    from repro_torch.core import ChipMesh
    return ChipMesh(("cuda:0",) * chips)


def hot_shard_csr(m: int = 64, n: int = 512, hot_nnz: int = 400,
                  seed: int = 0):
    """tests/test_xshard.py's ``_hot_csr``: all the weight in one row, so
    one chip's staged window dwarfs the others'."""
    from repro_torch.core import CSRMatrix
    rng = np.random.default_rng(seed)
    lengths = [hot_nnz] + [1] * (m - 1)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    cols = np.concatenate([np.sort(rng.choice(n, size=int(k), replace=False))
                           for k in lengths]).astype(np.int32)
    vals = rng.standard_normal(int(row_ptr[-1])).astype(np.float32)
    return CSRMatrix((m, n), row_ptr, cols, torch.from_numpy(vals).cuda())


def chip_walks(sw, bm: int, bk: int, cap) -> list:
    """The kinds of staged-walk items each chip's launch takes."""
    from repro_torch.kernels.spmm_ell_fused import staged_walk, staging_geometry
    walks = []
    for c in range(sw.n_chips):
        geo = staging_geometry(int(sw.chip_span[c]), int(sw.chip_cspan[c]),
                               bm=bm, bk=bk, cap=cap)
        tables = [torch.from_numpy(t[c]).long() for t in
                  (sw.blk_tag, sw.blk_off, sw.blk_coff, sw.blk_L)]
        walks.append({it[0] for it in staged_walk(
            *tables, bm=bm, bk=bk, mw=sw.merge_width, c=geo[0], ch=geo[1],
            kc=geo[2])})
    return walks


def sharded_knobs(c, staging: str, cap=None) -> dict:
    sw = c.sharded_workspace
    kw = dict(staging=staging, cap=cap)
    if staging == "dma":
        kw.update(span=sw.chip_span, cspan=sw.chip_cspan)
    return kw


def phase_sharded_fixtures(mesh_of=shard_mesh,
                           chip_counts=(1, 2, 3, 4)) -> None:
    """The three sharded wrappers against their plain versions on small
    fixtures (rtol = atol = 1e-5), and each one's workspaces, gathered
    through the GLOBAL ``inv_perm``, against the unsharded kernel's
    forward bit for bit: C in ``chip_counts`` on ``mesh_of(C)`` (C chips
    of the card, or one card a chip), both placements of X (SpMM), both
    stagings, the default slot and a 64-entry one."""
    from repro_torch import kernels
    from repro_torch.core import (CSRMatrix, JitCache,
                                  compile_sparse_attention, compile_spmm,
                                  random_csr)
    two_rows = np.array([[1.5, 0, -2.0, 0, 0.5], [0, 3.0, 0, 0, 0]],
                        np.float32)
    fixtures = {
        "mixed": CSRMatrix.from_dense(mixed_dense(0)),
        "empty_rows": random_csr(300, 256, density=0.03, family="powerlaw",
                                 seed=1),
        "two_rows": CSRMatrix.from_dense(two_rows),
        "hot_shard": hot_shard_csr(),
    }
    seen = dict(empty_chip=False, pad_descriptors=False, rows=False,
                hot_chip_alone_chunked=False)
    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = dict.fromkeys(SHARDED_KERNELS, 0.0)
    configs = dict.fromkeys(SHARDED_KERNELS, 0)

    def check(name, got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst[name] = max(worst[name], (got - want).abs().max().item())
        configs[name] += 1

    for (fname, a), backend in itertools.product(fixtures.items(),
                                                 ("pallas_ell",
                                                  "pallas_bcsr")):
        name = ("spmm_ell_fused_sharded" if backend == "pallas_ell"
                else "spmm_bcsr_fused_sharded")
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        x = torch.randn(a.n, D_MAIN, device="cuda", generator=gen)
        y0 = compile_spmm(a, D_MAIN, backend=backend, staging="resident",
                          cache=JitCache())(a.vals, x)
        for chips, staging, x_sharding in itertools.product(
                chip_counts, ("resident", "dma"), ("replicated", "rows")):
            c = compile_spmm(a, D_MAIN, backend=backend, staging=staging,
                             mesh=mesh_of(chips), x_sharding=x_sharding,
                             validate="full", cache=JitCache())
            sw = c.sharded_workspace
            seen["empty_chip"] |= bool(np.any(np.diff(sw.bounds) == 0))
            seen["pad_descriptors"] |= bool(np.any(sw.blk_L == 0))
            seen["rows"] |= sw.x_sharding == "rows"
            operands, knobs = c.sharded_operands(a.vals, x)
            outs = []
            for cap in ((None, 64) if staging == "dma" else (None,)):
                kw = dict(knobs, **sharded_knobs(c, staging, cap))
                before = wrapper.launches
                got = wrapper(*operands, **kw)
                assert wrapper.launches == before + chips, (fname, chips)
                check(name, got, plain(*operands, **kw))
                outs.append(got)
                if fname == "hot_shard" and staging == "dma" and chips > 1:
                    chunked = [w != {"trip"} for w in
                               chip_walks(sw, c.bm, c.bk, cap)]
                    hot = int(np.argmax(sw.chip_span))
                    seen["hot_chip_alone_chunked"] |= chunked == [
                        i == hot for i in range(chips)]
            assert all(torch.equal(o, outs[0]) for o in outs), (fname, chips)
            y = c._sharded.gather_rows(outs[0], D_MAIN, c.device)
            assert torch.equal(y, y0), (fname, backend, chips, staging,
                                        x_sharding)

    empty = CSRMatrix((4, 5), np.array([0, 2, 2, 3, 3]),
                      np.array([0, 3, 1], np.int32),
                      torch.ones(3, device="cuda"))
    masks = {"weighted": (weighted_mask(48, 40, 0.15, 3), 12, 20, 1.0),
             "multi_trip": (CSRMatrix.from_dense(multi_trip_dense()), 8, 8,
                            12.0),
             "empty_rows": (empty, 6, 6, 1.0)}
    for (fname, (a, dh, dv, scale)), backend in itertools.product(
            masks.items(), ("pallas_ell", "pallas_bcsr")):
        q = torch.randn(a.m, dh, device="cuda", generator=gen) * scale
        k = torch.randn(a.n, dh, device="cuda", generator=gen)
        v = torch.randn(a.n, dv, device="cuda", generator=gen)
        y0 = compile_sparse_attention(a, dh, dv, backend=backend,
                                      staging="resident",
                                      cache=JitCache())(a.vals, q, k, v)
        for chips, staging in itertools.product(chip_counts,
                                                ("resident", "dma")):
            c = compile_sparse_attention(a, dh, dv, backend=backend,
                                         staging=staging,
                                         mesh=mesh_of(chips),
                                         validate="full", cache=JitCache())
            operands, knobs = c.sharded_operands(a.vals, q, k, v)
            outs = []
            for cap in ((None, 64) if staging == "dma" else (None,)):
                kw = dict(knobs, **sharded_knobs(c, staging, cap))
                before = kernels.attn_fused_sharded.launches
                got = kernels.attn_fused_sharded(*operands, **kw)
                assert kernels.attn_fused_sharded.launches == before + chips
                check("attn_fused_sharded", got,
                      kernels.attn_fused_sharded_plain(*operands, **kw))
                outs.append(got)
            assert all(torch.equal(o, outs[0]) for o in outs), (fname, chips)
            y = c._sharded.gather_rows(outs[0], dv, c.device)
            assert torch.equal(y, y0), (fname, backend, chips, staging)
    log("sharded wrappers vs plain (rtol = atol = 1e-5), workspaces "
        "gathered through inv_perm bit-identical to the unsharded forward: "
        + "; ".join(f"{n}: {configs[n]} calls, max |kernel - plain| "
                    f"{worst[n]:.3g}" for n in SHARDED_KERNELS))
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise SystemExit(f"chip_smoke: sharded fixtures never reached "
                         f"{missing}")


def sharded_dispatches(c) -> dict:
    """The dispatch counts of one forward of sharded SpMM artifact
    ``c``: a launch a chip under each key that applies."""
    key = "bcsr_fused" if c.backend == "pallas_bcsr" else "ell_fused"
    chips = c.n_chips
    want = {key: chips, key + "_sharded": 1}
    if c.staging == "dma":
        want[key + "_dma"] = chips
    if c.x_sharding == "rows":
        want[key + "_xshard"] = chips
    if c.sharded_workspace.merge_width > 1:
        want[key + "_merged"] = chips
    return want


def attn_chip_bounds(a, sw, dh: int, dv: int) -> list:
    """Each chip's bound for its rows of sharded attention: (ms, "bytes"
    or "operations"), its Q, K, V, output and nonzeros once over the HBM
    rate or its operations over the fp32 rate, the larger."""
    out = []
    for chip in range(sw.n_chips):
        rows_c = int(sw.bounds[chip + 1] - sw.bounds[chip])
        nnz_c = int(sw.shard_plans[chip].nnz)
        t_bytes = (4 * (rows_c * dh + a.n * dh + a.n * dv + rows_c * dv)
                   + 8 * nnz_c) / HBM_BYTES_PER_S * 1e3
        t_ops = nnz_c * (2 * dh + 2 * dv) / FP32_FLOPS_PER_S * 1e3
        out.append((max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations"))
    return out


def sharded_bound(c, operands, chip_x) -> tuple:
    """K8's bound for one SpMM forward: each chip's bytes bound (its
    tables, values and X operand read once, its workspace written once)
    summed over the chips, plus the exchanged panels read and written
    once, over the HBM rate."""
    from repro_torch.core.plan import MXU_TAG
    sw = c.sharded_workspace
    bm, bk, d_pad = c.bm, c.bk, int(chip_x[0].shape[1])
    per_chip = []
    for chip in range(sw.n_chips):
        mxu = sw.blk_tag[chip] == MXU_TAG
        L = sw.blk_L[chip].astype(np.int64)
        chip_ops = [t[chip] for t in operands[:-1]] + [chip_x[chip]]
        per_chip.append(bound(chip_ops, sw.num_blocks * bm * d_pad,
                              int(bm * L[~mxu].sum()),
                              int(bm * bk * L[mxu].sum()), d_pad))
    xbytes = 0
    if sw.x_sharding == "rows":
        # the touched panels: sorted unique, panel 0 always first
        touched = sum(1 + int(np.count_nonzero(f)) for f in sw.x_fetch)
        xbytes = touched * bk * d_pad * 4
    total = sum(t for t, _ in per_chip) + 2 * xbytes / HBM_BYTES_PER_S * 1e3
    kind = ("bytes" if all(k == "bytes" for _, k in per_chip)
            else "operations")
    return total, kind, per_chip, xbytes


def measure_sharded(c, c0, a, x, label: str) -> dict:
    """Hold a sharded SpMM wrapper to its plain version at size, time it
    (and its exchange and each chip's kernel), the sharded and unsharded
    forwards and torch.sparse.mm, with K8's bound and the peak memory
    of each forward; return the wrapper's row of the JSON report."""
    from repro_torch import kernels
    from repro_torch.distributed import sharded_x
    name = ("spmm_ell_fused_sharded" if c.backend == "pallas_ell"
            else "spmm_bcsr_fused_sharded")
    wrapper = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    kernel_name, kernel, _ = kernel_pair(c.backend, c.staging)
    operands, knobs = c.sharded_operands(a.vals, x)
    kw = dict(knobs, **sharded_knobs(c, c.staging))
    got = wrapper(*operands, **kw)
    want = plain(*operands, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    err = (got - want).abs().max().item()
    del got, want
    sw = c._sharded
    mesh = sw.mesh

    def exchange():
        return sharded_x(operands[-1], mesh, sw.x_sharding, sw.x_send,
                         sw.x_recv)

    chip_x = exchange()
    bound_ms, bound_by, chip_bounds, xbytes = sharded_bound(c, operands,
                                                            chip_x)
    per = dict(bm=c.bm, mw=sw.merge_width)
    if c.backend == "pallas_bcsr":
        per["bk"] = c.bk
    chip_ms = []
    for chip in range(mesh.size):
        args = [t[chip] for t in operands[:-1]] + [chip_x[chip]]
        win = (dict(span=sw.chip_span[chip], cspan=sw.chip_cspan[chip])
               if c.staging == "dma" else {})
        chip_ms.append(time_ms(lambda: kernel(*args, **per, **win)))
    del chip_x
    exchange_ms = time_ms(exchange) if sw.x_sharding == "rows" else 0.0
    ms = time_ms(lambda: wrapper(*operands, **kw))
    fwd_ms = time_ms(lambda: c(a.vals, x))
    fwd0_ms = time_ms(lambda: c0(a.vals, x))
    plain_ms = time_ms(lambda: plain(*operands, **kw), reps=3)
    peaks = []
    for art in (c, c0):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        art(a.vals, x)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    a_sparse = _sparse_csr(a)
    library_ms = time_ms(lambda: torch.sparse.mm(a_sparse, x))
    del a_sparse
    log(f"sharded/{label} ({c.backend}/{c.staging}/{sw.x_sharding}): {name} "
        f"{ms:.4f} ms ({mesh.size} x {kernel_name}: "
        f"{', '.join(f'{t:.4f}' for t in chip_ms)}, summed "
        f"{sum(chip_ms):.4f} ms; exchange {exchange_ms:.4f} ms, "
        f"{xbytes / 2 ** 20:.1f} MiB of touched panels); sharded forward "
        f"{fwd_ms:.4f} ms against the unsharded forward {fwd0_ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms; torch.sparse.mm {library_ms:.4f} ms; "
        f"K8 bound {bound_ms:.4f} ms ({bound_by}; chips "
        f"{', '.join(f'{t:.4f}' for t, _ in chip_bounds)} + exchange); peak "
        f"memory over the resident inputs: sharded {peaks[0]:.3f} GiB, "
        f"unsharded {peaks[1]:.3f} GiB; max |kernel - plain| {err:.3g}; "
        f"B={sw.num_blocks} per chip, windows {list(sw.chip_span)}")
    return dict(name=name, route="cuda", **KERNELS[name], max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_sharded(instances: dict, compiled: dict, grad: tuple,
                  cache) -> dict:
    """K8 at size: ``compile_spmm(a, 128, mesh=4 chips on cuda:0)`` on
    the main path's two instances, each forward 4 launches and bit for
    bit the unsharded forward; dX and dvals of the default artifact bit
    for bit the grad phase's; the wrappers timed beside their bound."""
    from repro_torch import kernels
    from repro_torch.core import compile_spmm
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    phase_sharded_fixtures()
    log(f"sharded: small fixtures {time.perf_counter() - t0:.1f} s")
    mesh = shard_mesh()
    # label -> (instance, backend, staging, x_sharding); None = default
    runs = {"a": ("uniform", "auto", None, None),
            "a/rows": ("uniform", "auto", None, "rows"),
            "a/resident": ("uniform", "auto", "resident", None),
            "a/pallas_ell": ("uniform", "pallas_ell", None, None),
            "b": ("banded", "auto", None, None)}
    sharded = {}
    for label, (inst, backend, staging, x_sharding) in runs.items():
        a, _ = instances[inst]
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        c = compile_spmm(a, D_MAIN, backend=backend, staging=staging,
                         x_sharding=x_sharding, mesh=mesh, cache=cache)
        log(f"sharded/{label}: compile_spmm {time.perf_counter() - t0:.2f} "
            f"s (plan {ops.BUILD_SECONDS['plan']:.2f} s, pack "
            f"{ops.BUILD_SECONDS['pack']:.2f} s): {c.backend}/{c.staging}/"
            f"{c.x_sharding}, {c.n_chips} chips, rows per chip "
            f"{np.diff(c.sharded_workspace.bounds).tolist()}")
        assert c.staging == ("resident" if staging else "dma")
        # the chips share the card's memory: auto keeps X replicated
        assert c.x_sharding == (x_sharding or "replicated"), label
        sharded[label] = c

    # the path, counted: zeroed just before, read just after
    for name in SPMM_KERNELS + SHARDED_KERNELS:
        getattr(kernels, name).launches = 0
    outputs = {}
    for label, c in sharded.items():
        a, x = instances[runs[label][0]]
        key = "bcsr_fused" if c.backend == "pallas_bcsr" else "ell_fused"
        name, kernel, _ = kernel_pair(c.backend, c.staging)
        wrapper = getattr(kernels, f"spmm_{key}_sharded")
        before = (kernel.launches, wrapper.launches)
        ops.reset_dispatch_counts()
        outputs[label] = c(a.vals, x)
        assert dict(ops.DISPATCH_COUNTS) == sharded_dispatches(c), \
            (label, dict(ops.DISPATCH_COUNTS))
        assert (kernel.launches - before[0], wrapper.launches - before[1]) \
            == (SHARD_CHIPS, SHARD_CHIPS), (label, name)
    torch.cuda.synchronize()
    launches = {name: getattr(kernels, name).launches
                for name in SPMM_KERNELS + SHARDED_KERNELS}
    log(f"sharded path launches: {launches}")

    for label, y in outputs.items():
        a, x = instances[runs[label][0]]
        assert y.shape == (a.m, D_MAIN) and bool(torch.isfinite(y).all())
        # phase 4's artifact of the same backend and staging
        y0 = compiled[runs[label][:3]](a.vals, x)
        assert torch.equal(y, y0), label
        log(f"sharded/{label}: forward over {SHARD_CHIPS} chips "
            f"bit-identical to the unsharded {sharded[label].backend}/"
            f"{sharded[label].staging} forward")
        del y0
    del outputs

    # dvals and dX through the sharded default and rows artifacts on (a)
    a, x = instances["uniform"]
    g, dv0, _, dx0, _ = grad
    for label in ("a", "a/rows"):
        vals = a.vals.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        (sharded[label](vals, xx) * g).sum().backward()
        assert torch.equal(vals.grad, dv0) and torch.equal(xx.grad, dx0)
        t = sharded[label]._transpose
        assert t.mesh == mesh and t.x_sharding == sharded[label].x_sharding
        log(f"sharded/{label}: dvals and dX of (A·X * G).sum() "
            f"bit-identical to the grad phase's (transposed artifact "
            f"{t.backend}/{t.staging}/{t.x_sharding})")
        del vals, xx
    torch.cuda.empty_cache()

    rows = {}
    for label in ("a", "a/pallas_ell", "a/rows", "a/resident", "b"):
        a, x = instances[runs[label][0]]
        row = measure_sharded(sharded[label], compiled[runs[label][:3]], a,
                              x, label)
        if label in ("a", "a/pallas_ell"):
            rows[row["name"]] = row
    for name, row in rows.items():
        row["launches"] = launches[name]
    return rows


def phase_sharded_attention(a, q, k, v, y0, c0, library_ms: float) -> dict:
    """K8 for attention at size: ``compile_sparse_attention`` on mask (c)
    over 4 chips of the card, 4 K6 launches, bit for bit phase 9's
    default forward."""
    from repro_torch import kernels
    from repro_torch.core import JitCache, compile_sparse_attention
    from repro_torch.kernels import ops
    mesh = shard_mesh()
    t0 = time.perf_counter()
    c = compile_sparse_attention(a, q.shape[1], v.shape[1], mesh=mesh,
                                 cache=JitCache())
    sw = c.sharded_workspace
    log(f"sharded attention: compile_sparse_attention "
        f"{time.perf_counter() - t0:.2f} s: {c.backend}/{c.staging}, "
        f"{c.n_chips} chips, rows per chip {np.diff(sw.bounds).tolist()}, "
        f"B={sw.num_blocks} per chip, windows {sw.chip_span.tolist()}")
    assert c.backend == "pallas_bcsr" and c.staging == "dma"
    k6, k8 = kernels.attn_fused_staged, kernels.attn_fused_sharded
    k6.launches = k8.launches = 0
    ops.reset_dispatch_counts()
    y = c(a.vals, q, k, v)
    torch.cuda.synchronize()
    launches = k8.launches
    want = {"attn_fused": SHARD_CHIPS, "attn_fused_sharded": 1,
            "attn_fused_dma": SHARD_CHIPS}
    if sw.merge_width > 1:
        want["attn_fused_merged"] = SHARD_CHIPS
    assert dict(ops.DISPATCH_COUNTS) == want, dict(ops.DISPATCH_COUNTS)
    assert (k6.launches, k8.launches) == (SHARD_CHIPS, SHARD_CHIPS)
    assert torch.equal(y, y0)
    log(f"sharded attention: {SHARD_CHIPS} attn_fused_staged launches, "
        f"output bit-identical to the unsharded default forward")
    del y
    operands, knobs = c.sharded_operands(a.vals, q, k, v)
    kw = dict(knobs, **sharded_knobs(c, "dma"))
    got = k8(*operands, **kw)
    want_y = kernels.attn_fused_sharded_plain(*operands, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want_y, rtol=1e-5, atol=1e-5)
    err = (got - want_y).abs().max().item()
    del got, want_y
    chip_ms = []
    for chip in range(mesh.size):
        args = [t[chip] for t in operands[:6]] + [operands[6][chip],
                                                  operands[7], operands[8]]
        chip_ms.append(time_ms(lambda: k6(
            *args, bm=c.bm, bk=c.bk, mw=sw.merge_width,
            span=sw.chip_span[chip], cspan=sw.chip_cspan[chip])))
    chip_bounds = attn_chip_bounds(a, sw, q.shape[1], v.shape[1])
    bound_ms = sum(t for t, _ in chip_bounds)
    bound_by = ("operations" if all(k == "operations" for _, k in chip_bounds)
                else "bytes")
    ms = time_ms(lambda: k8(*operands, **kw))
    fwd_ms = time_ms(lambda: c(a.vals, q, k, v))
    fwd0_ms = time_ms(lambda: c0(a.vals, q, k, v))
    plain_ms = time_ms(lambda: kernels.attn_fused_sharded_plain(*operands,
                                                                **kw),
                       reps=3)
    log(f"sharded attention: attn_fused_sharded {ms:.4f} ms ({mesh.size} x "
        f"attn_fused_staged: {', '.join(f'{t:.4f}' for t in chip_ms)}, "
        f"summed {sum(chip_ms):.4f} ms); sharded forward {fwd_ms:.4f} ms "
        f"against the unsharded forward {fwd0_ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms; scaled_dot_product_attention {library_ms:.4f} "
        f"ms (phase 9); K8 bound {bound_ms:.4f} ms ({bound_by}; chips "
        f"{', '.join(f'{t:.4f}' for t, _ in chip_bounds)}); max |kernel - "
        f"plain| {err:.3g}")
    return dict(name="attn_fused_sharded", route="cuda",
                **KERNELS["attn_fused_sharded"], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# -- the serving tier: batched multi-tenant SpMM through K1-K4 ---------------

# the serve phase's tenants: (name, random_csr family, rows = columns,
# density, request width).  arxiv: ogbn-arxiv's 169,343 nodes and
# 1,166,243 edges (citation-graph GNN inference); web: a power-law graph,
# 16 edges a row on average; stencil: a 32-wide band (2-D stencil/FEM);
# fem27: a 27-wide band (3-D 27-point operator).  Widths 128 and 100
# share the 128 bucket, 64 and 40 the 64 bucket.
SERVE_TENANTS = (
    ("arxiv", "uniform", 169_343, 1_166_243 / 169_343 ** 2, 128),
    ("web", "powerlaw", 2 ** 17, 16 / 2 ** 17, 100),
    ("stencil", "banded", 2 ** 18, 32 / 2 ** 18, 64),
    ("fem27", "banded", 2 ** 17, 27 / 2 ** 17, 40),
)
# server configurations the serve phase drives: the card's defaults
# (pallas_bcsr, dma: K4), K3, and the resident kernels K2 and K1
SERVE_CONFIGS = (("default", {}), ("pallas_ell", dict(backend="pallas_ell")),
                 ("resident", dict(staging="resident")),
                 ("pallas_ell/resident", dict(backend="pallas_ell",
                                              staging="resident")))


def serve_requests():
    """The four tenants' requests: structures and values from
    ``random_csr`` seeds on the card, host operands from numpy."""
    from repro_torch.core import random_csr
    from repro_torch.launch.serve import SpmmRequest
    rng = np.random.default_rng(24)
    reqs = []
    for seed, (name, family, n, density, d) in enumerate(SERVE_TENANTS):
        t0 = time.perf_counter()
        a = random_csr(n, n, density=density, family=family, seed=100 + seed)
        x = rng.standard_normal((n, d)).astype(np.float32)
        log(f"serve/{name}: {family}, m = n = {n}, nnz = {a.nnz}, request "
            f"d = {d}; random_csr {time.perf_counter() - t0:.2f} s")
        reqs.append(SpmmRequest(tenant=name, a=a, x=x))
    return reqs


def table_bytes(artifact) -> int:
    """Device bytes of an artifact's descriptor tables and permutation."""
    consts = artifact._consts if hasattr(artifact, "_consts") \
        else artifact._fused
    return sum(t.numel() * t.element_size()
               for t in vars(consts).values() if isinstance(t, torch.Tensor))


class _Launches:
    """Sums the SpMM kernels' launch counts over the driven spans: each
    ``with`` block adds the counts its span moved."""

    def __init__(self):
        self.total = dict.fromkeys(SPMM_KERNELS, 0)

    @staticmethod
    def now() -> dict:
        from repro_torch import kernels
        return {name: getattr(kernels, name).launches
                for name in SPMM_KERNELS}

    def __enter__(self):
        self.before = self.now()
        return self

    def __exit__(self, *exc):
        after = self.now()
        self.last = {k: after[k] - self.before[k] for k in after}
        for k, v in self.last.items():
            self.total[k] += v
        return False


def check_served(req, y: torch.Tensor) -> tuple:
    """Hold a served output to a float64 reference: each element at
    rtol = atol = 1e-4, or, in rows so long that the order of an fp32
    sum alone moves it further, within that sum's error bound
    ``γ_L · Σ_j |a_ij x_jk|`` (L the row's length, γ_L = L·u / (1 −
    L·u), u = 2^-24), which any fp32 summation order meets.  Returns the
    largest error, the elements held to the bound and the largest error
    over bound among them."""
    a = req.a
    rows = torch.from_numpy(np.repeat(np.arange(a.m), a.row_lengths)).cuda()
    cols = torch.from_numpy(a.col_indices.astype(np.int64)).cuda()
    x = torch.from_numpy(req.x).cuda().double()
    v = a.vals.double()
    ref = torch.zeros((a.m, x.shape[1]), dtype=torch.float64,
                      device=x.device).index_add_(0, rows, v[:, None] * x[cols])
    mass = torch.zeros_like(ref).index_add_(0, rows,
                                            v.abs()[:, None] * x[cols].abs())
    u = 2.0 ** -24
    L = torch.from_numpy(a.row_lengths.astype(np.float64)).cuda()[:, None]
    bound = L * u / (1 - L * u) * mass
    err = (y.cuda().double() - ref).abs()
    plain = err <= 1e-4 + 1e-4 * ref.abs()
    outside = ~plain
    assert bool((err[outside] <= bound[outside]).all()), (
        req.tenant, err.max().item())
    ratio = (err[outside] / bound[outside]).max().item() \
        if bool(outside.any()) else 0.0
    return err.max().item(), int(outside.sum().item()), ratio


def check_round(server, reqs, resps, label: str, *, hits: bool,
                launched: dict) -> None:
    """One served round: every response from one fused launch of a
    two-member chunk, hit or miss as expected, held to a float64
    reference (``check_served``) and bit for bit its tenant's solo
    artifact."""
    from repro_torch.launch.serve import d_bucket
    from repro_torch.kernels import ops
    name, _, _ = kernel_pair(server.backend, server.staging)
    dispatch = "bcsr_fused" if server.backend == "pallas_bcsr" \
        else "ell_fused"
    dispatched = ops.DISPATCH_COUNTS[dispatch]
    assert dispatched == 2, dict(ops.DISPATCH_COUNTS)
    assert ops.DISPATCH_COUNTS[dispatch + "_dma"] == 2 * (
        server.staging == "dma"), dict(ops.DISPATCH_COUNTS)
    assert launched == {k: 2 * (k == name) for k in SPMM_KERNELS}, launched
    errs = []
    for req, resp in zip(reqs, resps):
        assert resp.tenant == req.tenant and resp.batch_size == 2, resp
        assert resp.cache_hit == hits, (label, req.tenant, resp.cache_hit)
        d = req.x.shape[1]
        y = torch.from_numpy(resp.y)
        assert y.shape == (req.a.m, d) and bool(torch.isfinite(y).all())
        x = torch.from_numpy(req.x).cuda()
        errs.append((req.tenant,) + check_served(req, y))
        b = d_bucket(d)
        solo = server.warmup(req.a, d)
        x_pad = torch.nn.functional.pad(x, (0, b - d))
        with torch.no_grad():
            y_solo = solo(req.a.vals, x_pad)[:, :d].cpu()
        assert torch.equal(y, y_solo), (label, req.tenant)
    log(f"serve/{label}: {server.backend}/{server.staging}, "
        f"{'hits' if hits else 'misses'}: 2 chunks, {dispatched} fused "
        f"dispatches, {name} launches {launched[name]}; every response "
        f"is bit-identical to its tenant's solo artifact and matches the "
        f"float64 reference (rtol = atol = 1e-4, else the fp32 summation "
        f"bound): " + "; ".join(
            f"{t} max |y - ref| {e:.3g}, {n} elements past 1e-4, "
            f"{r:.3f} of their bound" for t, e, n, r in errs))


def _union(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, reach = 0.0, None
    for lo, hi in sorted(spans):
        lo = lo if reach is None else max(lo, reach)
        if hi > lo:
            total += hi - lo
            reach = hi
    return total


def _overlap(spans, others) -> float:
    """Length of ``spans``' union that lies inside ``others``' union."""
    return sum(_union([(max(a, c), min(b, d)) for c, d in others
                       if min(b, d) > max(a, c)]) for a, b in spans)


def serve_profile(server, reqs) -> None:
    """One warm served round, two ways.  CUDA events: the stage's
    transfers on its side stream (events recorded on that stream around
    each item's pinning and copies) and the fused launches on the
    consumer's stream, and how much of the transfers' time overlaps a
    launch.  ``torch.profiler`` over the same round: the window, device
    busy and idle share, and the copies, copies back and kernels it
    recorded, with their streams."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    name, _, _ = kernel_pair(server.backend, server.staging)
    to_device, op = pipeline.DeviceStage._to_device, getattr(ops, name)
    copies, launched = [], []

    def event():
        return torch.cuda.Event(enable_timing=True)

    def timed_copy(stage, item):
        start, end = event(), event()
        start.record(stage._stream)
        staged = to_device(stage, item)
        end.record(stage._stream)
        copies.append((start, end))
        return staged

    def timed_launch(*args, **kw):
        start, end = event(), event()
        start.record()
        out = op(*args, **kw)
        end.record()
        launched.append((start, end))
        return out

    origin = event()
    pipeline.DeviceStage._to_device = timed_copy
    setattr(ops, name, timed_launch)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            origin.record()
            server.serve(reqs)
            torch.cuda.synchronize()
    finally:
        pipeline.DeviceStage._to_device = to_device
        setattr(ops, name, op)
    copy_spans = [(origin.elapsed_time(a), origin.elapsed_time(b))
                  for a, b in copies]
    launch_spans = [(origin.elapsed_time(a), origin.elapsed_time(b))
                    for a, b in launched]
    log(f"serve/stage: one warm round ({server.backend}/{server.staging}), "
        f"CUDA events: {len(copies)} staged items' transfers (pinning and "
        f"the copy on the side stream) in {_union(copy_spans):.4f} ms (spans "
        + ", ".join(f"{a:.3f}-{b:.3f}" for a, b in copy_spans)
        + f" ms from the round's start), {len(launched)} {name} launches in "
        f"{_union(launch_spans):.4f} ms ("
        + ", ".join(f"{a:.3f}-{b:.3f}" for a, b in launch_spans)
        + f"); {_overlap(copy_spans, launch_spans):.4f} ms of the "
        f"transfers overlap a launch")

    events = prof.events()
    device = [e for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.time_range.end > e.time_range.start]
    if not device:
        log("serve/profile: torch.profiler recorded no device time over a "
            "served round")
        return

    def spans(evs):
        return [(e.time_range.start / 1e3, e.time_range.end / 1e3)
                for e in evs]

    def streams(evs):
        return sorted({getattr(e, "device_resource_id", -1) for e in evs})

    groups = {"host-to-device copies": [e for e in device if "HtoD" in e.name],
              "device-to-host copies": [e for e in device if "DtoH" in e.name],
              "kernels": [e for e in device if "Memcpy" not in e.name
                          and "Memset" not in e.name]}
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) / 1e3
    busy = _union(spans(device))
    # a profiler session after the main phase's has been seen to keep
    # only some of a round's device events: say so rather than trust
    # its busy time
    seen = sum("gather_kernel" in e.name       # K1-K4's CTA template
               for e in groups["kernels"])
    note = ("" if seen >= len(launched) else
            f" (it recorded {seen} of the {len(launched)} {name} launches "
            f"the CUDA events saw: its busy time and idle share are "
            f"incomplete)")
    log(f"serve/profile: the same round under torch.profiler{note}: window "
        f"{window:.4f} ms, device busy {busy:.4f} ms, idle share "
        f"{100 * (1 - busy / window):.1f} %; "
        + "; ".join(f"{label} {len(evs)}, {_union(spans(evs)):.4f} ms on "
                    f"streams {streams(evs)}" for label, evs in groups.items())
        + f"; host-to-device copies overlapping a kernel "
        f"{_overlap(spans(groups['host-to-device copies']), spans(groups['kernels'])):.4f} ms")


def serve_times(server, reqs) -> None:
    """CUDA events: each bucket's batched forward against the sum of its
    members' solo forwards, and the fused kernel alone on the batch; one
    served round's wall time."""
    from repro_torch.core import compile_batched_spmm
    from repro_torch.launch.serve import d_bucket
    name, kernel, _ = kernel_pair(server.backend, server.staging)
    for b in sorted({d_bucket(r.x.shape[1]) for r in reqs}):
        members = [r for r in reqs if d_bucket(r.x.shape[1]) == b]
        c = compile_batched_spmm([r.a for r in members], b,
                                 backend=server.backend,
                                 staging=server.staging, cache=server.cache)
        x = torch.from_numpy(c.stack_inputs([r.x for r in members])).cuda()
        vals = torch.cat([r.a.vals for r in members])
        with torch.no_grad():
            batched_ms = time_ms(lambda: c.forward(vals, x))
            operands, knobs = c.fused_operands(vals, x)
            fw = c._consts
            if server.staging == "dma":
                knobs.update(span=fw.max_span, cspan=fw.max_cspan)
            kernel_ms = time_ms(lambda: kernel(*operands, **knobs))
            solo_ms, solo_kernel_ms = [], []
            for r in members:
                s = server.warmup(r.a, r.x.shape[1])
                xs = torch.nn.functional.pad(torch.from_numpy(r.x).cuda(),
                                             (0, b - r.x.shape[1]))
                solo_ms.append(time_ms(lambda: s(r.a.vals, xs)))
                ops_s, knobs_s = s.fused_operands(r.a.vals, xs)
                if server.staging == "dma":
                    knobs_s.update(windows(s))
                solo_kernel_ms.append(time_ms(lambda: kernel(*ops_s,
                                                             **knobs_s)))
                del ops_s
        log(f"serve/bucket {b} ({'+'.join(r.tenant for r in members)}, "
            f"{server.backend}/{server.staging}): batched forward "
            f"{batched_ms:.4f} ms against the members' solo forwards "
            f"{' + '.join(f'{t:.4f}' for t in solo_ms)} = "
            f"{sum(solo_ms):.4f} ms; {name} alone on the batch "
            f"{kernel_ms:.4f} ms against "
            f"{' + '.join(f'{t:.4f}' for t in solo_kernel_ms)} = "
            f"{sum(solo_kernel_ms):.4f} ms on the members alone "
            f"(B={fw.num_blocks}, mw={fw.merge_width}, max_span "
            f"{fw.max_span}, stacked X {tuple(x.shape)})")
        del c, x, operands
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        server.serve(reqs)
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"serve/round wall: {', '.join(f'{w:.1f}' for w in walls)} ms "
        f"(3 warm rounds of {len(reqs)} requests, host operands in, host "
        f"outputs back)")


def serve_autotune(reqs, launches: _Launches) -> None:
    """``compile_spmm(arxiv, 128, autotune=True)`` with the default
    CUDA-event measure: every candidate's predicted ms and the
    finalists' measured ms; the output ``torch.equal`` to
    ``compile_spmm`` of the winner; a second call a pure hit.  Then an
    autotuning server serves one batch with the knobs
    ``resolve_batch_config`` folds from its members' winners (the 64
    bucket: fem27 and arxiv's graph at width 40)."""
    from repro_torch.core import JitCache, compile_spmm
    from repro_torch.core.autotune import (default_candidates,
                                           lookup_tune_result,
                                           resolve_batch_config)
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import SpmmRequest, SpmmServer
    arxiv = reqs[0]
    a = arxiv.a
    cache = JitCache()
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    with launches:
        c = compile_spmm(a, 128, autotune=True, cache=cache)
    wall = time.perf_counter() - t0
    res = lookup_tune_result(a, 128, backend=c.backend, device=c.device,
                             candidates=default_candidates(staging=c.staging),
                             cache=cache)
    assert res is not None and c.strategy == res.config.strategy
    for cfg, pred in sorted(res.predicted_s.items(), key=lambda kv: kv[1]):
        meas = res.measured_s.get(cfg)
        log(f"serve/autotune arxiv: {cfg.strategy} merge_threshold "
            f"{cfg.merge_threshold} {cfg.staging}: predicted "
            f"{pred * 1e3:.4f} ms"
            + ("" if meas is None else f", measured {meas * 1e3:.4f} ms")
            + (" (winner)" if cfg == res.config else ""))
    log(f"serve/autotune arxiv: search {res.tune_seconds:.2f} s "
        f"(BUILD_SECONDS tune {ops.BUILD_SECONDS['tune']:.2f} s, compile "
        f"{wall:.2f} s wall), launches {launches.last}")
    x = torch.from_numpy(arxiv.x).cuda()
    winner = compile_spmm(a, 128, cache=JitCache(),
                          **res.config.compile_kwargs())
    with torch.no_grad():
        assert torch.equal(c(a.vals, x), winner(a.vals, x))
    del winner
    misses = cache.stats()["misses"]
    assert compile_spmm(a, 128, autotune=True, cache=cache) is c
    assert cache.stats()["misses"] == misses
    log("serve/autotune arxiv: output bit-identical to compile_spmm of the "
        "winner; the second autotune compile is a pure cache hit")
    # the 64 bucket, fem27 and arxiv's graph at width 40: web's search
    # would build row_split's ELL padded to its 10,876-long rows, a
    # (131072 x 10876) int64 slot array, 10.6 GiB of host memory and
    # minutes of planning for one candidate; stencil's (8.4 M nonzeros)
    # adds tens of seconds
    server = SpmmServer(max_batch=4, autotune=True, cache=cache)
    members = [reqs[3], SpmmRequest("arxiv", a, arxiv.x[:, :40])]
    tune0 = ops.BUILD_SECONDS["tune"]
    t0 = time.perf_counter()
    with launches:
        resps = server.serve(members)
    wall = time.perf_counter() - t0
    results = [lookup_tune_result(r.a, 64, backend=server.backend,
                                  device=server.device,
                                  candidates=server._tune_candidates,
                                  cache=cache) for r in members]
    cfg = resolve_batch_config(results, server._fallback_config)
    (key,) = [k for k in cache._entries if k[0] == "spmm_batch"]
    batched = cache.peek(key)
    assert (batched.strategy, batched.staging, batched.bm, batched.bk) == (
        cfg.strategy, cfg.staging, cfg.bm, cfg.bk), (batched.strategy, cfg)
    errs = []
    for r, resp in zip(members, resps):
        assert resp.batch_size == 2
        errs.append((r.tenant,) + check_served(r, torch.from_numpy(resp.y)))
    log(f"serve/autotune server: fem27+arxiv (d 40) as one batch in "
        f"{wall:.2f} s wall (their searches {ops.BUILD_SECONDS['tune'] - tune0:.2f} s) "
        f"with the folded knobs {cfg} (winners: "
        f"{', '.join(f'{r.tenant} {res.config.strategy}/{res.config.merge_threshold}' for r, res in zip(members, results))}), "
        f"each response held to the float64 reference: " + "; ".join(
            f"{t} max |y - ref| {e:.3g}, {n} elements past 1e-4, "
            f"{q:.3f} of their bound" for t, e, n, q in errs)
        + f"; launches {launches.last}")


def serve_memory(reqs, caches) -> None:
    """Device memory falls with no ``gc.collect()``: on ``cache.clear()``
    of the caches the phase filled, by at least their artifacts' tables,
    and on eviction from ``JitCache(capacity=2)``."""
    from repro_torch.core import JitCache
    from repro_torch.launch.serve import SpmmServer
    torch.cuda.synchronize()
    for cache in caches:
        tables = sum(table_bytes(e.value) for e in cache._entries.values()
                     if hasattr(e.value, "_consts")
                     or getattr(e.value, "_fused", None) is not None)
        before = torch.cuda.memory_allocated()
        cache.clear()
        after = torch.cuda.memory_allocated()
        assert before - after >= tables, (before, after, tables)
        log(f"serve/memory: cache.clear() {before / 2**30:.3f} -> "
            f"{after / 2**30:.3f} GiB allocated (fell "
            f"{(before - after) / 2**30:.3f} GiB; the artifacts' tables "
            f"{tables / 2**30:.3f} GiB), no gc.collect()")
    cache = JitCache(capacity=2)
    server = SpmmServer(max_batch=1, cache=cache)
    from repro_torch.launch.serve import SpmmRequest
    fem27, arxiv = reqs[3], reqs[0]
    # arxiv's structure again at width 40: a third artifact, 64 bucket
    arxiv40 = SpmmRequest("arxiv", arxiv.a, arxiv.x[:, :40])
    server.serve([fem27])
    server.serve([arxiv])            # fem27 is now least recent
    evicted = table_bytes(cache.peek(next(iter(cache._entries))))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    server.serve([arxiv40])          # evicts fem27's artifact
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    added = table_bytes(server.warmup(arxiv.a, 40))
    assert cache.stats()["evictions"] == 1
    assert after <= before - evicted + added + 2 ** 20, (
        before, after, evicted, added)
    assert after < before
    log(f"serve/memory: eviction at JitCache(capacity=2) {before / 2**30:.3f} "
        f"-> {after / 2**30:.3f} GiB allocated (fem27's tables "
        f"{evicted / 2**30:.3f} GiB out, arxiv's at d 40 "
        f"{added / 2**30:.3f} GiB in), no gc.collect()")


def phase_serve() -> dict:
    """The serving tier at tenant sizes (see the module docstring)."""
    from repro_torch.core import JitCache
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import SpmmScheduler, SpmmServer
    t_phase = time.perf_counter()
    reqs = serve_requests()
    launches = _Launches()
    caches = []
    direct = None
    for label, kw in SERVE_CONFIGS:
        server = SpmmServer(max_batch=4, cache=JitCache(), **kw)
        caches.append(server.cache)
        if label == "default":
            assert (server.backend, server.staging) == ("pallas_bcsr", "dma")
        for rnd in (1, 2):
            ops.reset_dispatch_counts()
            t0 = time.perf_counter()
            with launches:
                resps = server.serve(reqs)
            wall = time.perf_counter() - t0
            log(f"serve/{label}: round {rnd} {wall:.2f} s wall "
                f"(plan {ops.BUILD_SECONDS['plan']:.2f} s, pack "
                f"{ops.BUILD_SECONDS['pack']:.2f} s)")
            check_round(server, reqs, resps, f"{label}/round {rnd}",
                        hits=rnd == 2, launched=launches.last)
        if label != "default":
            continue
        direct = resps
        # the scheduler, on manual ticks and on its thread: bit for bit
        # the direct round
        for executor in (None, "thread"):
            with launches:
                sched = SpmmScheduler(server, max_queue_per_tenant=8,
                                      executor=executor)
                futures = [sched.submit(r) for r in reqs]
                sched.close(drain=True)
            for req, fut, want in zip(reqs, futures, direct):
                got = fut.result(timeout=60)
                assert not fut.rejected, got
                assert np.array_equal(got.y, want.y), (executor, req.tenant)
            cb = sched.stats()
            log(f"serve/scheduler ({executor or 'manual ticks'}): "
                f"{cb['dispatched']} dispatched in {cb['ticks']} ticks, "
                f"{cb['rejected']} rejected; outputs bit-identical to "
                f"round 2; launches {launches.last}")
        serve_times(server, reqs)
        serve_profile(server, reqs)
    serve_autotune(reqs, launches)
    serve_memory(reqs, caches)
    del caches, direct
    log(f"serve: launches {launches.total}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches.total


# -- the sparse-attention sandwich: K5 / K6 -----------------------------------

def weighted_mask(m: int, n: int, density: float, seed: int):
    """tests/test_attn_fused.py's ``_mask``: a powerlaw pattern with mask
    weights in [0.2, 2), on the card."""
    from repro_torch.core import CSRMatrix, random_csr
    s = random_csr(m, n, density=density, family="powerlaw", seed=seed)
    w = np.random.default_rng(seed + 1).uniform(0.2, 2.0, s.nnz)
    return CSRMatrix(s.shape, s.row_ptr, s.col_indices,
                     torch.tensor(w, dtype=torch.float32, device="cuda"))


def multi_trip_dense() -> np.ndarray:
    """tests/test_attn_fused.py's multi-trip fixture: a dense heavy row
    and a 40-wide one span many trips."""
    rng = np.random.default_rng(7)
    dense = np.zeros((24, 64), np.float32)
    dense[0] = rng.uniform(0.2, 2.0, 64)
    dense[1, :40] = rng.uniform(0.2, 2.0, 40)
    for i in range(2, 24):
        cols = rng.choice(64, size=rng.integers(1, 5), replace=False)
        dense[i, cols] = rng.uniform(0.2, 2.0, cols.size)
    return dense


def over_cap_dense(n: int = 1152, seed: int = 5) -> np.ndarray:
    """A 1100-wide row, a dense 8-row block-row over 256 columns and a
    sparse tail: windows over the default 1024-entry staging slot."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((40, n), np.float32)
    dense[3, :1100] = rng.uniform(0.2, 2.0, 1100)
    dense[8:16, :256] = rng.uniform(0.2, 2.0, (8, 256))
    for i in range(16, 40):
        dense[i, rng.choice(n, size=2, replace=False)] = rng.uniform(0.2, 2.0,
                                                                     2)
    return dense


def vpu_shapes(ws, vals, S: int) -> tuple:
    """Whether a workspace has a VPU descriptor whose steps end part-way
    through a group of ``S`` (K6's VPU group), and one whose rows hold
    different numbers of nonzero weights (padding, weight 0, fills the
    shorter rows)."""
    partial = ragged = False
    for b in np.flatnonzero(ws.blk_tag == 0):
        L, off = int(ws.blk_L[b]), int(ws.blk_off[b])
        partial |= L % S != 0
        if L:
            rows = vals[off:off + ws.row_block * L].reshape(ws.row_block, L)
            counts = np.count_nonzero(rows, axis=1)
            ragged |= bool(counts.min() != counts.max())
    return partial, ragged


def phase_attn_kernels() -> None:
    """K5 and K6 against their plain versions, K6 against K5."""
    from repro_torch.core import CSRMatrix, JitCache, compile_sparse_attention
    from repro_torch.core.plan import MXU_TAG
    from repro_torch.kernels import (attn_fused, attn_fused_plain,
                                     attn_fused_staged,
                                     attn_fused_staged_plain)
    from repro_torch.kernels.spmm_ell_fused import (staged_walk,
                                                    staging_geometry)
    kv_geometry = _kernel_module("attn_fused").kv_geometry
    empty = CSRMatrix((4, 5), np.array([0, 2, 2, 3, 3]),
                      np.array([0, 3, 1], np.int32),
                      torch.ones(3, device="cuda"))
    # name -> (mask, dh, dv, q scale)
    fixtures = {
        "weighted": (weighted_mask(48, 40, 0.15, 3), 12, 20, 1.0),
        "multi_trip": (CSRMatrix.from_dense(multi_trip_dense()), 8, 8, 12.0),
        "empty_rows": (empty, 6, 6, 1.0),
        "over_cap": (CSRMatrix.from_dense(over_cap_dense()), 128, 128, 1.0),
    }
    seen = dict(merged=False, mxu_bk1=False, mxu_bk8=False,
                chunked_vpu=False, chunked_mxu=False, unaligned=False,
                vpu_partial_group=False, vpu_ragged_rows=False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = worst_staged = worst_fwd = 0.0
    configs = 0
    # bk = 1 and 8 for the MXU blocks; pallas_ell tags none
    backends = (("pallas_ell", 8), ("pallas_bcsr", 8), ("pallas_bcsr", 1))
    for (fname, (a, dh, dv, scale)), (backend, bk), mt, bm in (
            itertools.product(fixtures.items(), backends, (0, 16),
                              (1, 2, 4, 8, 16))):
        c = compile_sparse_attention(a, dh, dv, backend=backend, bm=bm,
                                     bk=bk, merge_threshold=mt,
                                     staging="resident", validate="full",
                                     cache=JitCache())
        ws = c.workspace
        q = torch.randn(a.m, dh, device="cuda", generator=gen) * scale
        k = torch.randn(a.n, dh, device="cuda", generator=gen)
        v = torch.randn(a.n, dv, device="cuda", generator=gen)
        operands, knobs = c.fused_operands(a.vals, q, k, v)
        win = dict(span=ws.max_span, cspan=ws.max_cspan)
        got = attn_fused(*operands, **knobs)
        want = attn_fused_plain(*operands, **knobs)
        got_s = attn_fused_staged(*operands, **knobs, **win)
        want_s = attn_fused_staged_plain(*operands, **knobs, **win)
        # a 64-entry slot: the chunked walk on every fixture
        got_64 = attn_fused_staged(*operands, **knobs, **win, cap=64)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
        assert torch.equal(got_s, got), (fname, backend, bk, mt, bm)
        assert torch.equal(got_64, got), (fname, backend, bk, mt, bm, 64)
        worst = max(worst, (got - want).abs().max().item())
        worst_staged = max(worst_staged, (got_s - want_s).abs().max().item())
        if fname != "over_cap":
            y = c(a.vals, q, k, v)
            ref = compile_sparse_attention(a, dh, dv, backend="ref",
                                           cache=JitCache())(a.vals, q, k, v)
            torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
            worst_fwd = max(worst_fwd, (y - ref).abs().max().item())
        configs += 1
        seen["merged"] |= ws.merge_width > 1
        mxu = bool(np.any(ws.blk_tag == MXU_TAG))
        seen["mxu_bk1"] |= mxu and bk == 1
        seen["mxu_bk8"] |= mxu and bk == 8
        seen["unaligned"] |= bool(np.any(ws.blk_off % 4))
        group = kv_geometry(bm=bm, bk=bk, dh_pad=int(operands[6].shape[1]))
        partial, ragged = vpu_shapes(ws, operands[5].cpu().numpy(),
                                     group["group"])
        seen["vpu_partial_group"] |= partial
        seen["vpu_ragged_rows"] |= ragged
        geo = staging_geometry(ws.max_span, ws.max_cspan, bm=bm, bk=c.bk)
        tables = [torch.from_numpy(t).long() for t in
                  (ws.blk_tag, ws.blk_off, ws.blk_coff, ws.blk_L)]
        kinds = {it[0] for it in staged_walk(
            *tables, bm=bm, bk=c.bk, mw=ws.merge_width, c=geo[0], ch=geo[1],
            kc=geo[2])}
        seen["chunked_vpu"] |= "vpu" in kinds
        seen["chunked_mxu"] |= "mxu" in kinds
    log(f"attention kernels: {configs} configurations (bm 1-16, MXU bk 1 "
        f"and 8, the default and a 64-entry slot); attn_fused: max "
        f"|kernel - plain| = {worst:.3g}; attn_fused_staged: bit-identical "
        f"to attn_fused, max |kernel - plain| = {worst_staged:.3g} (rtol = "
        f"atol = 1e-5); forwards vs ref max |diff| {worst_fwd:.3g} (1e-5)")
    worst_k5, reached = k5_head_widths(fixtures["over_cap"][0], gen)
    log(f"attention kernels: attn_fused alone at head widths attn_fused_"
        f"staged does not take ({', '.join(reached)}): max |kernel - "
        f"plain| = {worst_k5:.3g} (rtol = atol = 1e-5)")
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise SystemExit(f"chip_smoke: attention fixtures never reached "
                         f"{missing}")


def k5_head_widths(a, gen) -> tuple:
    """K5 against its plain version on mask ``a`` (MXU blocks and VPU
    rows) at the head widths K6 does not take, called directly on the
    artifact's operands cut to the width: ragged (100), a ring of one
    stage (bm = 16, bk = 32, 1024) and none (LEAN, 4096).  Returns the
    largest difference and the geometries reached."""
    from repro_torch.core import JitCache, compile_sparse_attention
    from repro_torch.core.plan import MXU_TAG
    from repro_torch.kernels import attn_fused, attn_fused_plain
    attn = _kernel_module("attn_fused")
    worst, reached = 0.0, set()
    for backend, bm, bk, dh in (("pallas_bcsr", 8, 8, 100),
                                ("pallas_ell", 4, 8, 100),
                                ("pallas_bcsr", 16, 32, 1024),
                                ("pallas_bcsr", 8, 8, 4096),
                                ("pallas_ell", 8, 8, 4096)):
        c = compile_sparse_attention(a, dh, 128, backend=backend, bm=bm,
                                     bk=bk, staging="resident",
                                     cache=JitCache())
        assert backend == "pallas_ell" or np.any(
            c.workspace.blk_tag == MXU_TAG), (backend, bm, bk)
        q = torch.randn(a.m, dh, device="cuda", generator=gen) / dh ** 0.5
        k = torch.randn(a.n, dh, device="cuda", generator=gen)
        v = torch.randn(a.n, 128, device="cuda", generator=gen)
        ops, knobs = c.fused_operands(a.vals, q, k, v)
        ops = list(ops)
        ops[6] = ops[6][:, :dh].contiguous()
        ops[7] = ops[7][:, :dh].contiguous()
        got = attn_fused(*ops, **knobs)
        want = attn_fused_plain(*ops, **knobs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        worst = max(worst, (got - want).abs().max().item())
        stages = attn.resident_geometry(bm=bm, bk=bk,
                                        dh_pad=attn.head_width(dh))["stages"]
        reached.add("ragged" if dh % 32 else
                    "LEAN" if stages == 0 else f"{stages} stage(s)")
    want = {"ragged", "1 stage(s)", "LEAN"}
    if not want <= reached:
        raise SystemExit(f"chip_smoke: K5's head widths never reached "
                         f"{sorted(want - reached)}")
    return worst, sorted(reached)


def attn_bound(a, dh: int, dv: int):
    """The least time for one head's attention on the card: Q, K, V and
    the output once plus a 4-byte weight and a 4-byte column per nonzero
    over the HBM rate, or 2*dh + 2*dv fp32 flops per nonzero over the
    fp32 rate — the larger."""
    nbytes = 4 * (a.m * dh + a.n * dh + a.n * dv + a.m * dv) + 8 * a.nnz
    flops = float(a.nnz) * (2 * dh + 2 * dv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    kind = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), kind, t_bytes, t_ops


def bool_mask(a) -> torch.Tensor:
    """The mask ``a`` as a dense boolean matrix on the card (SDPA's)."""
    rows = torch.from_numpy(np.repeat(np.arange(a.m), a.row_lengths)).cuda()
    cols = torch.from_numpy(a.col_indices.astype(np.int64)).cuda()
    dense = torch.zeros((a.m, a.n), dtype=torch.bool, device="cuda")
    dense[rows, cols] = True
    return dense


def phase_attention() -> tuple:
    """compile_sparse_attention on the longformer-1.4b mask, one head;
    returns the kernels' report rows and, for the sharded attention
    check, the mask, Q, K, V, the default forward's output, its artifact
    and the library time."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import JitCache, compile_sparse_attention
    from repro_torch.kernels import ops
    from repro_torch.models.sparse_attention import sparse_attention_mask

    cfg = get_config("longformer-1.4b")
    dh = dv = cfg.head_dim
    t0 = time.perf_counter()
    a = sparse_attention_mask(ATTN_SEQ, cfg.sparse_attn_window,
                              cfg.sparse_attn_global)
    log(f"attention: longformer-1.4b mask, S = {ATTN_SEQ}, window "
        f"{cfg.sparse_attn_window}, {cfg.sparse_attn_global} global "
        f"columns: nnz = {a.nnz} ({time.perf_counter() - t0:.2f} s)")
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(a.m, dh, device="cuda", generator=gen)
    k = torch.randn(a.n, dh, device="cuda", generator=gen)
    v = torch.randn(a.n, dv, device="cuda", generator=gen)
    cache = JitCache()
    compiled = {}
    for backend, staging in itertools.product(("pallas_bcsr", "pallas_ell"),
                                              (None, "resident")):
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        c = compile_sparse_attention(a, dh, dv, backend=backend,
                                     staging=staging, cache=cache)
        ws = c.workspace
        log(f"attention/{backend}/{c.staging}: compile_sparse_attention "
            f"{time.perf_counter() - t0:.2f} s (pack "
            f"{ops.BUILD_SECONDS['pack']:.2f} s, validate={c.validate}); "
            f"B={ws.num_blocks} mw={ws.merge_width} max_span={ws.max_span}")
        assert c.staging == ("dma" if staging is None else "resident")
        compiled[(backend, c.staging)] = c

    # the path, counted: zeroed just before, read just after
    for name in ATTN_KERNELS:
        getattr(kernels, name).launches = 0
    outputs = {}
    for key, c in compiled.items():
        kernel = kernels.attn_fused_staged if key[1] == "dma" \
            else kernels.attn_fused
        ops.reset_dispatch_counts()
        before = kernel.launches
        outputs[key] = c(a.vals, q, k, v)
        assert ops.DISPATCH_COUNTS["attn_fused"] == 1
        assert ops.DISPATCH_COUNTS["attn_fused_dma"] == (key[1] == "dma")
        assert kernel.launches == before + 1
    torch.cuda.synchronize()
    launches = {n: getattr(kernels, n).launches for n in ATTN_KERNELS}
    log(f"attention path launches: {launches}")

    ref = compile_sparse_attention(a, dh, dv, backend="ref",
                                   cache=cache)(a.vals, q, k, v)
    for key, y in outputs.items():
        assert y.shape == (a.m, dv) and bool(torch.isfinite(y).all())
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
        line = (f"attention/{key[0]}/{key[1]}: forward matches ref, max "
                f"|y - ref| = {(y - ref).abs().max().item():.3g} (rtol = "
                f"atol = 1e-4)")
        if key[1] == "dma":
            assert torch.equal(y, outputs[(key[0], "resident")]), key
            line += ", bit-identical to the resident forward"
        log(line)
    del ref

    # the library yardstick: dense SDPA with the mask as a boolean matrix
    dense_mask = bool_mask(a)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None],
            attn_mask=dense_mask)[0, 0]

    y_lib = sdpa()
    lib_diff = (y_lib - outputs[("pallas_bcsr", "dma")]).abs().max().item()
    del y_lib
    library_ms = time_ms(sdpa, reps=5)
    bound_ms, bound_by, t_bytes, t_ops = attn_bound(a, dh, dv)
    log(f"attention: scaled_dot_product_attention with the dense boolean "
        f"mask {library_ms:.4f} ms (median of 5), max |sdpa - default "
        f"forward| {lib_diff:.3g}; bound {bound_ms:.4f} ms ({bound_by}; "
        f"bytes {t_bytes:.4f}, operations {t_ops:.4f}; "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, {FP32_FLOPS_PER_S / 1e12:.0f} "
        f"TFLOP/s fp32)")
    y_default = outputs[("pallas_bcsr", "dma")]
    del dense_mask, outputs
    torch.cuda.empty_cache()

    results = {}
    for key, c in compiled.items():
        name = "attn_fused_staged" if key[1] == "dma" else "attn_fused"
        kernel = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        operands, knobs = c.fused_operands(a.vals, q, k, v)
        if key[1] == "dma":
            knobs.update(span=c.workspace.max_span,
                         cspan=c.workspace.max_cspan)
        got = kernel(*operands, **knobs)
        want = plain(*operands, **knobs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        del got, want
        ms = time_ms(lambda: kernel(*operands, **knobs))
        fwd_ms = time_ms(lambda: c(a.vals, q, k, v))
        plain_ms = time_ms(lambda: plain(*operands, **knobs), reps=5)
        ws = c.workspace
        L = ws.blk_L.astype(np.int64)
        mxu = ws.blk_tag != 0
        slots = int(c.bm * L[~mxu].sum() + c.bm * c.bk * L[mxu].sum())
        log(f"attention/{key[0]}/{key[1]}: {name} kernel {ms:.4f} ms, "
            f"forward {fwd_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), workspace slots {slots} "
            f"(padding {slots / a.nnz:.3f}x), max |kernel - plain| "
            f"{err:.3g}")
        if key[0] == "pallas_bcsr":        # the card's default backend
            results[name] = dict(
                name=name, route="cuda", **KERNELS[name], max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
                launches=launches[name])
    return ({name: results[name] for name in ATTN_KERNELS},
            (a, q, k, v, y_default, compiled[("pallas_bcsr", "dma")],
             library_ms))


class _Patched:
    """While active, replaces the named module attributes (``(module,
    attribute)`` pairs) with ``self.wrap(target, original)``."""

    def __init__(self, *targets):
        self.targets = targets

    def __enter__(self):
        import importlib
        self.saved = []
        for target in self.targets:
            mod = importlib.import_module(target[0])
            orig = getattr(mod, target[1])
            self.saved.append((mod, target[1], orig))
            setattr(mod, target[1], self.wrap(target, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        return False


class _PlainCalls(_Patched):
    """Counts calls of the named module attributes while it is active —
    plain versions, or the ``_Carry`` that each attention plain version
    builds once: the card's path must run none."""

    def __enter__(self):
        self.calls = 0
        return super().__enter__()

    def wrap(self, target, orig):
        def counted(*args, **kw):
            self.calls += 1
            return orig(*args, **kw)
        return counted


class _Spans(_Patched):
    """Brackets every call of the named module attributes with two CUDA
    events on the current stream while it is active; ``spans[target]``
    lists the event pairs, ``last[target]`` the last call's arguments."""

    def __enter__(self):
        self.spans = {t: [] for t in self.targets}
        self.last = {}
        return super().__enter__()

    def wrap(self, target, orig):
        def spanned(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = orig(*args, **kw)
            end.record()
            self.spans[target].append((start, end))
            self.last[target] = (orig, args, kw)
            return out
        return spanned

    def ms(self, target) -> float:
        return sum(a.elapsed_time(b) for a, b in self.spans[target])


def phase_sattn() -> dict:
    """The longformer-1.4b sattn layer at full width on the card."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.sparse_attention import (
        sparse_self_attention_layer)

    cfg = get_config("longformer-1.4b")
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    log(f"sattn: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated "
        f"as the phase begins")
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, scale=0.02):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    params = {"ln": 1.0 + rand(D, scale=0.1), "wq": rand(D, H, hd),
              "wk": rand(D, KV, hd), "wv": rand(D, KV, hd),
              "wo": rand(H, hd, D)}
    x = rand(SATTN_BATCH, SATTN_SEQ, D, scale=1.0)
    g = rand(SATTN_BATCH, SATTN_SEQ, D, scale=1.0)
    positions = torch.arange(SATTN_SEQ, device="cuda")[None].expand(
        SATTN_BATCH, SATTN_SEQ)
    kw = dict(positions=positions, head_dim=hd, num_heads=H, num_kv_heads=KV,
              window=cfg.sparse_attn_window,
              num_global=cfg.sparse_attn_global, rope_theta=cfg.rope_theta,
              qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)

    def run(backend):
        p = {n: w.detach().clone().requires_grad_(True)
             for n, w in params.items()}
        y = sparse_self_attention_layer(p, x, backend=backend, **kw)
        return p, y

    t0 = time.perf_counter()
    run("auto")
    torch.cuda.synchronize()
    log(f"sattn: d_model {D}, {H} heads over {KV} KV heads, head_dim {hd}, "
        f"S = {SATTN_SEQ}, batch {SATTN_BATCH}, float32; first forward "
        f"(mask + plan) {time.perf_counter() - t0:.2f} s")

    # the path, counted: one forward and its backward
    k6 = kernels.attn_fused_staged
    for name in ATTN_KERNELS:
        getattr(kernels, name).launches = 0
    ops.reset_dispatch_counts()
    with _PlainCalls(("repro_torch.kernels.attn_fused", "_Carry")) as plain:
        p, y = run("auto")
        torch.cuda.synchronize()
        forward = {n: getattr(kernels, n).launches for n in ATTN_KERNELS}
        assert forward == {"attn_fused": 0,
                           "attn_fused_staged": SATTN_BATCH * H}, forward
        assert ops.DISPATCH_COUNTS["attn_fused_dma"] == SATTN_BATCH * H
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        (y * g).sum().backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    assert plain.calls == 0, plain.calls
    assert k6.launches == SATTN_BATCH * H, k6.launches  # none in backward
    p_ref, y_ref = run("ref")
    (y_ref * g).sum().backward()
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    y_diff = (y - y_ref).abs().max().item()
    g_diff = 0.0
    for name in params:
        torch.testing.assert_close(p[name].grad, p_ref[name].grad,
                                   rtol=1e-4, atol=1e-4)
        g_diff = max(g_diff,
                     (p[name].grad - p_ref[name].grad).abs().max().item())
    log(f"sattn: {forward['attn_fused_staged']} attn_fused_staged launches "
        f"a forward; output max |diff| {y_diff:.3g} and weight gradients "
        f"max |diff| {g_diff:.3g} vs the ref layer (rtol = atol = 1e-4); "
        f"no plain version ran")
    del p, y, p_ref, y_ref

    def fwd():
        with torch.no_grad():
            run("auto")

    def fwd_bwd():
        pp, yy = run("auto")
        (yy * g).sum().backward()

    fwd_ms = time_ms(fwd, reps=5)
    step_ms = time_ms(fwd_bwd, reps=5)
    log(f"sattn: layer forward {fwd_ms:.4f} ms, forward + backward "
        f"{step_ms:.4f} ms (CUDA events, median of 5); backward peak memory "
        f"{peak / 2**30:.3f} GiB allocated ({(peak - base) / 2**30:.3f} GiB "
        f"over the {base / 2**30:.3f} GiB held before it)")
    launch_ms = split_layer_forward(fwd, SATTN_BATCH * H)
    return dict(launches=forward["attn_fused_staged"], fwd_ms=fwd_ms,
                step_ms=step_ms, peak=peak, launch_ms=launch_ms)


def split_layer_forward(fwd, heads: int, reps: int = 5) -> float:
    """The sattn layer forward's parts by CUDA events around each call
    of them, medians over ``reps`` forwards: the K6 wrapper's 16 calls
    (each launch with its trip counter's zeroing; a span also holds any
    wait of the card for the host), the Q/K/V projections, RoPE, and the
    rest (the norm, the output projection, the per-head operand gathers
    and the stacking) as the whole forward less those.  Then K6 alone on
    the last head's operands (CUDA events, median of 20): the launch's
    time at S = 4096, which it returns."""
    parts = {"attn_fused_staged": ("repro_torch.kernels.ops",
                                   "attn_fused_staged"),
             "Q/K/V projections": ("repro_torch.models.layers",
                                   "attn_project_qkv"),
             "RoPE": ("repro_torch.models.layers", "apply_rope")}
    calls = {"attn_fused_staged": heads, "Q/K/V projections": 1, "RoPE": 2}
    rows = []
    for _ in range(reps + 1):       # the first is a warm-up
        with _Spans(*parts.values()) as spans:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fwd()
            end.record()
            torch.cuda.synchronize()
        for name, target in parts.items():
            assert len(spans.spans[target]) == calls[name], (
                name, len(spans.spans[target]))
        row = {name: spans.ms(t) for name, t in parts.items()}
        row["forward"] = start.elapsed_time(end)
        row["rest"] = row["forward"] - sum(row[n] for n in parts)
        rows.append(row)
    med = {n: statistics.median(r[n] for r in rows[1:]) for n in rows[0]}
    k6, args, kw = spans.last[parts["attn_fused_staged"]]
    launch_ms = time_ms(lambda: k6(*args, **kw))
    log(f"sattn: one layer forward by CUDA events around its parts "
        f"(medians of {reps}): {med['forward']:.4f} ms = attn_fused_staged "
        f"{med['attn_fused_staged']:.4f} in {heads} calls + Q/K/V "
        f"projections {med['Q/K/V projections']:.4f} + RoPE "
        f"{med['RoPE']:.4f} + the rest (norm, output projection, per-head "
        f"gathers, stacking) {med['rest']:.4f}; attn_fused_staged alone "
        f"on one head's operands {launch_ms:.4f} ms a launch at S = "
        f"{SATTN_SEQ} (CUDA events, median of {REPS})")
    return launch_ms


# -- the decoder stack (phase 11, ``model``) --------------------------------

# (m1) longformer-1.4b at full width and depth: the forward's batch and
# sequence; (m2) generate(): batch, prompt and new tokens; (m3)
# mixtral-8x7b cut to MIXTRAL_LAYERS of 32 layers: the forward's sequence,
# and generate's batch, prompt and new tokens; (m4) new tokens of each
# reduced architecture's greedy generate on the card
MODEL_SEQ, MODEL_BATCH = 4096, 1
GEN_BATCH, GEN_PROMPT, GEN_TOKENS = 4, 1024, 32
MIXTRAL_LAYERS, MOE_SEQ = 2, 4096
MOE_GEN_BATCH, MOE_GEN_PROMPT = 4, 512
# a prompt longer than mixtral's 4096-slot window ring and not a multiple
# of it, then decode steps that each evict the position leaving the
# window; prompt and prompt + tokens - 1 (the forward it is held to) are
# multiples of the attention's 512-query chunks, as gqa_attention needs
MOE_WRAP_PROMPT, MOE_WRAP_TOKENS = 4608, 513
REDUCED_GEN = 8
# logits of the 24-layer fp32 stack against the same weights composed
# from the layer functions with the sattn layer on the ref backend: each
# layer's K6 output differs from ref only by its fp32 sum order (1.0e-06
# on unit-scale inputs, the sattn phase), and the residual stream carries
# those differences through 24 layers.  Measured on the H100: max |diff|
# 5.29e-05 to 5.64e-05 with |max| logit 5.59, so the atol term alone
# leaves under 2x headroom and rtol·|ref| adds up to 5.6e-04 on the
# largest logits; the bar holds a sum-order difference, not more
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)   # tests/test_models.py's bar


def model_config(name: str, **cut):
    """A registered configuration with the run's cuts (``dtype``,
    ``num_layers``)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), **cut)


def tree_leaves(tree) -> list:
    return [leaf for v in tree.values()
            for leaf in (tree_leaves(v) if isinstance(v, dict) else [v])]


def gib(tree) -> float:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) \
        / 2 ** 30


def ref_composition(cfg, params, tokens):
    """forward_train's logits composed from the layer functions, the
    sattn layer on the ``ref`` backend: an independent path to the same
    weights' logits."""
    from repro_torch.models import layers
    from repro_torch.models.sparse_attention import (
        sparse_self_attention_layer)
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device="cuda")[None].expand(B, S)
    slot = params["period"]["slot0"]
    for i in range(cfg.num_layers):
        attn = {k: v[i] for k, v in slot["sattn"].items()}
        ffn = {k: v[i] for k, v in slot["ffn_dense"].items()}
        x = sparse_self_attention_layer(
            attn, x, positions=positions, head_dim=cfg.head_dim,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            window=cfg.sparse_attn_window,
            num_global=cfg.sparse_attn_global, rope_theta=cfg.rope_theta,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps, backend="ref")
        x = layers.swiglu_mlp(ffn, x, norm_eps=cfg.norm_eps)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"]).float()


def forward_split(forward, calls: int, reps: int = 3) -> tuple:
    """Medians over ``reps`` forwards (after one warm-up) of the whole
    forward and of its K6 wrapper calls, by CUDA events around each;
    each forward must make exactly ``calls`` of them."""
    target = ("repro_torch.kernels.ops", "attn_fused_staged")
    rows = []
    for _ in range(reps + 1):
        with _Spans(target) as spans:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            forward()
            end.record()
            torch.cuda.synchronize()
        assert len(spans.spans[target]) == calls, len(spans.spans[target])
        rows.append((start.elapsed_time(end), spans.ms(target)))
    fwd = statistics.median(r[0] for r in rows[1:])
    k6 = statistics.median(r[1] for r in rows[1:])
    return fwd, k6


def generate_times(model, params, prompts, gen: int, reps: int = 3) -> dict:
    """CUDA-event medians of ``prefill`` alone and of a whole greedy
    ``generate`` (after a warm-up of each): the decode steps' ms a token
    is their difference over the ``gen - 1`` steps; then one decode step
    under ``torch.profiler`` (``profile_decode``)."""
    from repro_torch.launch.serve import generate
    B, S = prompts.shape
    cache_len = S + gen + 1
    with torch.no_grad():
        pre = time_ms(lambda: model.prefill(params, prompts, cache_len),
                      reps=reps)
        total = time_ms(lambda: generate(model, params, prompts,
                                         gen_len=gen, cache_len=cache_len),
                        reps=reps)
    step = (total - pre) / (gen - 1)
    return dict(prefill_ms=pre, generate_ms=total, ms_per_token=step,
                tokens_per_s=B * gen / (total / 1e3),
                profile=profile_decode(model, params, prompts))


def profile_decode(model, params, prompts) -> str:
    """One warm decode step under ``torch.profiler``: the kernel launches
    the host makes (its ``cudaLaunchKernel`` calls), the kernels the
    device ran and their time, and the device's idle share of the step's
    window (first to last event recorded, host or device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, S = prompts.shape
    last = prompts[:, -1:]
    with torch.no_grad():
        _, caches = model.prefill(params, prompts, S + 3)
        model.decode_step(params, last, caches, S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(params, last, caches, S + 1)
            torch.cuda.synchronize()
    del caches
    events = prof.events()
    calls = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                for e in events)
    device = [(e.time_range.start / 1e3, e.time_range.end / 1e3, e.name)
              for e in events
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not device:
        return (f"decode step under torch.profiler: {calls} launch calls by "
                f"the host, no device time recorded (idle share not "
                f"measured)")
    kernels = [(a, b) for a, b, name in device
               if "Memcpy" not in name and "Memset" not in name]
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) / 1e3
    busy = _union([(a, b) for a, b, _ in device])
    note = ("" if len(kernels) >= calls else
            f" (it recorded {len(kernels)} kernels for {calls} launch "
            f"calls: its busy time and idle share are incomplete)")
    return (f"decode step under torch.profiler{note}: {calls} launch calls "
            f"by the host, {len(kernels)} kernels on the device "
            f"({_union(kernels):.4f} ms), window {window:.4f} ms, device "
            f"busy {busy:.4f} ms, idle share {100 * (1 - busy / window):.1f}"
            f" %")


def model_longformer() -> int:
    """(m1) longformer-1.4b at full width and depth through
    ``Model.loss_fn`` (384 K6 launches, counted), held to the ref
    composition, timed at fp32 and bf16; (m2) ``generate`` on its
    weights, prefill and each decode step held to ``forward_train``.
    Returns the counted forward's K6 launches."""
    from repro_torch import kernels
    from repro_torch.convert import model_params_to
    from repro_torch.kernels import ops
    from repro_torch.models import Model, transformer

    cfg = model_config("longformer-1.4b", dtype="float32")
    B, S, H = MODEL_BATCH, MODEL_SEQ, cfg.num_heads
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(13)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"model/longformer-1.4b: {cfg.num_layers} sattn layers, d_model "
        f"{cfg.d_model}, {H} heads, vocab {cfg.vocab_size}: {n_params} "
        f"parameters, {gib(params):.3f} GiB at fp32, init "
        f"{time.perf_counter() - t0:.2f} s; card {card_line()}")
    tok = torch.randint(2, cfg.vocab_size, (B, S + 1), device="cuda",
                        generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    launches = cfg.num_layers * B * H
    with torch.no_grad():
        t0 = time.perf_counter()
        model.loss_fn(params, batch)          # the mask, plan and artifact
        torch.cuda.synchronize()
        log(f"model/longformer-1.4b: first loss_fn (mask + plan) "
            f"{time.perf_counter() - t0:.2f} s")
        # the main path, counted: zeroed just before, read just after
        for name in ATTN_KERNELS:
            getattr(kernels, name).launches = 0
        ops.reset_dispatch_counts()
        with _PlainCalls(("repro_torch.kernels.attn_fused",
                          "_Carry")) as plain:
            loss, parts = model.loss_fn(params, batch)
            torch.cuda.synchronize()
        counted = {n: getattr(kernels, n).launches for n in ATTN_KERNELS}
        assert counted == {"attn_fused": 0,
                           "attn_fused_staged": launches}, counted
        assert ops.DISPATCH_COUNTS["attn_fused_dma"] == launches
        assert plain.calls == 0, plain.calls
        # at init the logits are near-normal with std 0.02·sqrt(d_model)
        # (0.9 here), which puts the loss about 0.4 over ln V
        loss = float(loss)
        assert np.isfinite(loss) and abs(loss - np.log(cfg.vocab_size)) \
            < 1.0, loss
        logits, _ = transformer.forward_train(cfg, params, batch["tokens"])
        ref = ref_composition(cfg, params, batch["tokens"])
        diff = (logits - ref).abs().max().item()
        torch.testing.assert_close(logits, ref, **MODEL_TOL)
        log(f"model/longformer-1.4b: loss_fn at init {loss:.4f} (ln V = "
            f"{np.log(cfg.vocab_size):.4f}), {counted['attn_fused_staged']} "
            f"attn_fused_staged launches a forward ({cfg.num_layers} layers "
            f"x batch {B} x {H} heads), no plain version; logits (|max| "
            f"{logits.abs().max().item():.3f}) max |diff| {diff:.3g} vs the "
            f"layer functions with sattn on ref (rtol = atol = "
            f"{MODEL_TOL['rtol']:g})")
        del logits, ref
        for label, p in (("fp32", params),
                         ("bf16", model_params_to(params,
                                                  dtype=torch.bfloat16))):
            bcfg = cfg if label == "fp32" else model_config(
                "longformer-1.4b")
            fwd, k6 = forward_split(
                lambda: transformer.forward_train(bcfg, p, batch["tokens"]),
                launches)
            log(f"model/longformer-1.4b {label}: forward_train {fwd:.4f} ms "
                f"(CUDA events, median of 3), of which {launches} "
                f"attn_fused_staged calls {k6:.4f} ms ({100 * k6 / fwd:.1f} "
                f"%); card {card_line()}")
            del p
    torch.cuda.empty_cache()
    model_generate(cfg, model, params, gen)
    return counted["attn_fused_staged"]


def decode_consistency(cfg, model, params, prompts, T: int, *,
                       tol=DECODE_TOL) -> tuple:
    """Greedy ``generate`` of ``T`` tokens after ``prompts``: its tokens
    equal to a prefill + decode loop's, prefill's logits held to
    ``forward_train``'s on the prompt and each decode step's to
    ``forward_train``'s on the generated sequence at ``tol`` (2e-3 unless
    given).  Returns the two max |diff| and the caches after the last
    decode step."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer
    B, S = prompts.shape
    cache_len = S + T + 1
    with torch.no_grad():
        out = generate(model, params, prompts, gen_len=T,
                       cache_len=cache_len)
        assert out.shape == (B, S + T), out.shape
        pre, caches = model.prefill(params, prompts, cache_len)
        full, _ = transformer.forward_train(cfg, params, out[:, :-1])
        d_pre = (pre - full[:, :S]).abs().max().item()
        torch.testing.assert_close(pre, full[:, :S], **tol)
        del pre
        last = torch.argmax(full[:, S - 1:S], dim=-1)
        assert torch.equal(last, out[:, S:S + 1])
        d_dec = 0.0
        for pos in range(S, S + T - 1):
            logits, caches = model.decode_step(params, out[:, pos:pos + 1],
                                               caches, pos)
            d_dec = max(d_dec, (logits - full[:, pos:pos + 1]).abs().max()
                        .item())
            torch.testing.assert_close(logits, full[:, pos:pos + 1], **tol)
            assert torch.equal(torch.argmax(logits, dim=-1),
                               out[:, pos + 1:pos + 2]), pos
    return d_pre, d_dec, caches


def model_generate(cfg, model, params, gen) -> None:
    """(m2) greedy ``generate`` on longformer-1.4b's weights held to
    ``forward_train`` (``decode_consistency``: the dense masked fallback
    against K6), then timed at fp32 and bf16."""
    from repro_torch.convert import model_params_to
    from repro_torch.models import Model
    B, S, T = GEN_BATCH, GEN_PROMPT, GEN_TOKENS
    cache_len = S + T + 1
    prompts = torch.randint(2, cfg.vocab_size, (B, S), device="cuda",
                            generator=gen)
    d_pre, d_dec, _ = decode_consistency(cfg, model, params, prompts, T)
    log(f"model/generate longformer-1.4b: batch {B}, prompt {S}, {T} new "
        f"tokens, cache_len {cache_len}: prefill logits max |diff| "
        f"{d_pre:.3g} and {T - 1} decode steps' max |diff| {d_dec:.3g} vs "
        f"forward_train (K6) on the generated sequence (rtol = atol = "
        f"2e-3); every generated token the decode loop's argmax")
    for label, p, pcfg in (
            ("fp32", params, cfg),
            ("bf16", model_params_to(params, dtype=torch.bfloat16),
             model_config("longformer-1.4b"))):
        t = generate_times(Model(pcfg), p, prompts, T)
        log(f"model/generate longformer-1.4b {label}: prefill "
            f"{t['prefill_ms']:.4f} ms, generate {t['generate_ms']:.4f} ms, "
            f"{t['ms_per_token']:.4f} ms a decode step (batch {B}), "
            f"{t['tokens_per_s']:.1f} tokens/s (CUDA events, medians of "
            f"3); {t['profile']}; card {card_line()}")
        del p
    torch.cuda.empty_cache()


def model_ring_wrap(cfg, params, gen) -> None:
    """(m3) mixtral's sliding-window ring past its wrap: a prompt of
    MOE_WRAP_PROMPT tokens (over the 4096-slot ring, not a multiple of
    it) and MOE_WRAP_TOKENS greedy tokens (each decode step evicts one
    position), held to ``forward_train``
    (``decode_consistency``), whose window masks every position more
    than 4095 back; the ring must then hold each of the last 4096
    positions p in slot p % 4096.  Capacity is raised to C = T tokens
    (capacity_factor E / top_k) so that no assignment is dropped in
    either path: at 1.25 the full forward drops assignments that a
    one-token decode step keeps, and the two would differ by routing."""
    import dataclasses
    from repro_torch.models import Model, transformer
    wcfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                               / cfg.top_k)
    S, T = MOE_WRAP_PROMPT, MOE_WRAP_TOKENS
    ring = transformer.attn_cache_len(wcfg, S + T + 1)
    assert ring == cfg.sliding_window < S and S % ring, (ring, S)
    prompts = torch.randint(2, cfg.vocab_size, (1, S), device="cuda",
                            generator=gen)
    d_pre, d_dec, caches = decode_consistency(wcfg, Model(wcfg), params,
                                              prompts, T)
    last = S + T - 2                        # the last decoded position
    want = torch.empty(ring, dtype=torch.int32, device="cuda")
    held = torch.arange(last - ring + 1, last + 1, dtype=torch.int32,
                        device="cuda")
    want[held.long() % ring] = held
    for slot, cache in caches.items():
        assert torch.equal(cache["kpos"], want.expand_as(cache["kpos"])), \
            slot
    del caches
    log(f"model/generate mixtral-8x7b ring wrap: batch 1, prompt {S} into "
        f"the {ring}-slot window ring ({S} % {ring} = {S % ring}), {T} new "
        f"tokens, capacity factor {wcfg.capacity_factor:g} (no drops): "
        f"prefill logits max |diff| {d_pre:.3g} and {T - 1} decode steps' "
        f"max |diff| {d_dec:.3g} vs forward_train on the generated sequence "
        f"(rtol = atol = 2e-3); the ring holds positions {last - ring + 1}"
        f"-{last}, each p in slot p % {ring}")
    torch.cuda.empty_cache()


def model_mixtral() -> int:
    """(m3) mixtral-8x7b at full width, 2 of 32 layers, fp32: on the first
    MoE layer's normed input (batch 1, S = 4096, C = 1280), dispatch
    bit for bit Sᵀ·tokens through ``compile_spmm`` (K4 at d = 4096),
    combine at 1e-5 against S·expert_out, ``moe_apply_concrete`` on
    ``backend="auto"`` against the gather path at the reference's bar;
    K4 timed there; then ``loss_fn``, ``generate`` and the window ring
    past its wrap (``model_ring_wrap``).  Returns K4's counted
    launches."""
    from repro_torch import kernels
    from repro_torch.core import JitCache, compile_spmm
    from repro_torch.convert import model_params_to
    from repro_torch.core import moe_spmm as ms
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model, layers
    from repro_torch.models.moe import moe_capacity

    cfg = model_config("mixtral-8x7b", num_layers=MIXTRAL_LAYERS,
                       dtype="float32")
    E, k, D = cfg.num_experts, cfg.top_k, cfg.d_model
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(17)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    log(f"model/mixtral-8x7b: {cfg.num_layers} of 32 layers, d_model {D}, "
        f"{E} experts top-{k}, d_ff {cfg.d_ff}, window "
        f"{cfg.sliding_window}: {sum(t.numel() for t in tree_leaves(params))}"
        f" parameters, {gib(params):.3f} GiB at fp32, init "
        f"{time.perf_counter() - t0:.2f} s")
    S = MOE_SEQ
    tok = torch.randint(2, cfg.vocab_size, (1, S + 1), device="cuda",
                        generator=gen)
    cache = JitCache()
    with torch.no_grad():
        p0 = {n: {k_: v[0] for k_, v in d.items()} for n, d in
              params["period"]["slot0"].items()}
        x = params["embed"][tok[:, :-1]]
        positions = torch.arange(S, device="cuda")[None]
        x = layers.self_attention_layer(
            p0["attn"], x, positions=positions, head_dim=cfg.head_dim,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            qk_norm=cfg.qk_norm, norm_eps=cfg.norm_eps)
        moe_p = p0["ffn_moe"]
        h = layers.rms_norm(x[0], moe_p["ln"], cfg.norm_eps)     # (T, D)
        del x
        logits = h @ moe_p["router"]
        C = moe_capacity(S, k, E, cfg.capacity_factor)
        gates, eids, slots = ms.topk_routing(logits, k, C)
        xe = ms.dispatch(h, eids, slots, E, C)
        s_csr = ms.routing_to_csr(gates, eids, slots, E, C)
        s_ones = type(s_csr)(s_csr.shape, s_csr.row_ptr, s_csr.col_indices,
                             torch.ones(s_csr.nnz, device="cuda"))
        st, _ = s_ones.transpose_structure()
        c_t = compile_spmm(st, D, cache=cache)
        c_s = compile_spmm(s_csr, D, cache=cache)
        assert (c_t.backend, c_t.staging) == ("pallas_bcsr", "dma")
        w = {n: moe_p[n] for n in ("w_gate", "w_up", "w_down")}
        oe = (torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe,
                                                    w["w_gate"]))
              * torch.einsum("ecd,edf->ecf", xe, w["w_up"]))
        oe = torch.einsum("ecf,efd->ecd", oe, w["w_down"])
        combined = ms.combine(oe, gates, eids, slots)
        gather = ms.combine(torch.einsum(
            "ecf,efd->ecd", torch.nn.functional.silu(torch.einsum(
                "ecd,edf->ecf", xe, w["w_up"])), w["w_down"]),
            gates, eids, slots)
        # the concrete-routing path, counted: zeroed just before, read
        # just after
        for name in SPMM_KERNELS:
            getattr(kernels, name).launches = 0
        xe_k = c_t(st.vals, h)
        y_k = c_s(s_csr.vals, oe.reshape(E * C, D))
        y_c = ms.moe_apply_concrete(h, logits, w["w_up"], w["w_down"],
                                    top_k=k, capacity=C, backend="auto",
                                    cache=cache)
        torch.cuda.synchronize()
        counted = {n: getattr(kernels, n).launches for n in SPMM_KERNELS}
        assert counted == {"spmm_ell_fused": 0, "spmm_bcsr_fused": 0,
                           "spmm_ell_fused_staged": 0,
                           "spmm_bcsr_fused_staged": 4}, counted
        kept = int((slots < C).sum())
        assert torch.equal(xe_k.reshape(E, C, D), xe), \
            "dispatch differs from Sᵀ·tokens"
        torch.testing.assert_close(y_k, combined, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(y_c, gather, rtol=1e-4, atol=1e-5)
        log(f"model/mixtral-8x7b MoE layer 0: T = {S}, C = {C}, S "
            f"{s_csr.shape[0]} x {s_csr.shape[1]} with {s_csr.nnz} gates "
            f"({S * k - kept} of {S * k} assignments dropped at capacity); "
            f"dispatch bit-identical to Sᵀ·tokens through compile_spmm "
            f"(pallas_bcsr/dma, d = {D}); combine max |diff| "
            f"{(y_k - combined).abs().max().item():.3g} vs S·expert_out "
            f"(rtol = atol = 1e-5); moe_apply_concrete(backend=\"auto\") max "
            f"|diff| {(y_c - gather).abs().max().item():.3g} vs the gather "
            f"path (rtol 1e-4, atol 1e-5); spmm_bcsr_fused_staged "
            f"{counted['spmm_bcsr_fused_staged']} launches")
        row = measure(c_t, st, h, "moe/dispatch Sᵀ·tokens")
        measure(c_s, s_csr, oe.reshape(E * C, D), "moe/combine S·expert_out")
        del xe, xe_k, oe, y_k, y_c, combined, gather, h, logits
    del c_t, c_s, cache
    torch.cuda.empty_cache()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with torch.no_grad():
        loss, parts = model.loss_fn(params, batch)
        loss = float(loss)
        assert np.isfinite(loss), loss
        for label, p, pcfg in (
                ("fp32", params, cfg),
                ("bf16", model_params_to(params, dtype=torch.bfloat16),
                 model_config("mixtral-8x7b", num_layers=MIXTRAL_LAYERS))):
            fwd = time_ms(lambda: Model(pcfg).loss_fn(p, batch), reps=3)
            log(f"model/mixtral-8x7b {label}: loss_fn {fwd:.4f} ms (batch 1,"
                f" S = {S}, CUDA events, median of 3); card {card_line()}")
            del p
    log(f"model/mixtral-8x7b: loss at init {loss:.4f} (nll "
        f"{float(parts['nll']):.4f}, moe aux {float(parts['moe_aux']):.4f})")
    torch.cuda.empty_cache()
    B, P, T = MOE_GEN_BATCH, MOE_GEN_PROMPT, GEN_TOKENS
    prompts = torch.randint(2, cfg.vocab_size, (B, P), device="cuda",
                            generator=gen)
    with torch.no_grad():
        out = generate(model, params, prompts, gen_len=T,
                       cache_len=P + T + 1)
    assert out.shape == (B, P + T) and int(out.max()) < cfg.vocab_size
    for label, p, pcfg in (
            ("fp32", params, cfg),
            ("bf16", model_params_to(params, dtype=torch.bfloat16),
             model_config("mixtral-8x7b", num_layers=MIXTRAL_LAYERS))):
        t = generate_times(Model(pcfg), p, prompts, T)
        log(f"model/generate mixtral-8x7b {label}: batch {B}, prompt {P}, "
            f"{T} new tokens, ring cache of "
            f"{min(cfg.sliding_window, P + T + 1)} slots (no wrap): prefill "
            f"{t['prefill_ms']:.4f} ms, generate {t['generate_ms']:.4f} ms, "
            f"{t['ms_per_token']:.4f} ms a decode step, "
            f"{t['tokens_per_s']:.1f} tokens/s (CUDA events, medians of 3);"
            f" {t['profile']}; card {card_line()}")
        del p
    torch.cuda.empty_cache()
    model_ring_wrap(cfg, params, gen)
    del params
    torch.cuda.empty_cache()
    log(f"model/mixtral-8x7b: K4 at d = {D} on Sᵀ: {row['ms']:.4f} ms "
        f"against its bound {row['bound_ms']:.4f} ms ({row['bound_by']}) and "
        f"torch.sparse.mm {row['library_ms']:.4f} ms")
    return counted["spmm_bcsr_fused_staged"]


def model_reduced() -> None:
    """(m4) every architecture at ``reduced()``: the same weights
    on the card and the CPU, forward_train's logits within 1e-4, and a
    greedy generate of REDUCED_GEN tokens on the card."""
    from repro_torch.configs import all_arch_names, get_config, reduced
    from repro_torch.convert import model_params_to
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model, transformer
    worst = {}
    for seed, arch in enumerate(all_arch_names()):
        cfg = reduced(get_config(arch))
        model = Model(cfg)
        cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
        card = model_params_to(cpu, device="cuda")
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 16)))
        img = None
        if cfg.family == "vlm":
            img = torch.from_numpy((rng.standard_normal(
                (2, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(
                    np.float32))
        with torch.no_grad():
            want, _ = transformer.forward_train(
                cfg, cpu, tok, image_embeds=img, device="cpu")
            got, _ = transformer.forward_train(
                cfg, card, tok, image_embeds=None if img is None
                else img.cuda())
            out = generate(model, card, tok[:, :8], gen_len=REDUCED_GEN,
                           cache_len=8 + REDUCED_GEN + 1,
                           image_embeds=None if img is None else img.cuda())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        assert out.shape == (2, 8 + REDUCED_GEN) and out.is_cuda
        assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
        worst[arch] = (got.cpu() - want).abs().max().item()
    log(f"model/reduced: {len(worst)} architectures at reduced(), card vs "
        f"CPU logits max |diff| "
        + ", ".join(f"{a} {d:.3g}" for a, d in worst.items())
        + f" (rtol = atol = 1e-4); each generated {REDUCED_GEN} tokens on "
        f"the card")


# rwkv6-1.6b at full size (m5): loss_fn at batch 1 over RWKV_SEQ tokens
# (16 chunks of 256); a prefill of RECURRENT_PROMPT tokens and
# RECURRENT_STEPS decode steps held to forward_train on the same tokens at
# MODEL_TOL; generate at batch 4, prompt 512, 32 tokens
RWKV_SEQ = 4096
RECURRENT_PROMPT, RECURRENT_STEPS = 512, 256
# jamba-1.5-large-398b cut to the first JAMBA_SLOTS slots of its period
# (mamba x 4, then attention; MoE on slots 1 and 3) at full width and the
# config's bf16: 44.8 GiB of weights; loss_fn and generate at batch 4,
# prompt 512, JAMBA_GEN_TOKENS tokens.  Its decode is held to
# forward_train at fp32 (JAMBA_TOL) on the period's slots JAMBA_CHECK
# (mamba, mamba + MoE, attention; 48.2 GiB at fp32, where the five slots'
# 89.6 GiB do not fit): a prompt of JAMBA_PROMPT and JAMBA_STEPS steps, a
# 512-token forward of two mamba chunks and one attention query chunk.
# At bf16 a last-bit difference in a router input flips a near-tie
# between experts, and the token's logits then differ by whole units.
# JAMBA_TOL is MODEL_TOL with its atol scaled to the cut's sums: logits of
# std 0.02·sqrt(8192) = 1.81 (longformer's 0.91) from contractions over
# 8192-24576 terms (longformer's 2048-8192), so a sum-order difference
# of about 2 x 2 = 4 times longformer's; at MODEL_TOL two of 131,072
# logits of a decode step missed by 1.12e-4 on the H100
JAMBA_SLOTS, JAMBA_CHECK = 5, slice(2, 5)
JAMBA_TOL = dict(rtol=1e-4, atol=4e-4)
JAMBA_PROMPT, JAMBA_STEPS, JAMBA_GEN_TOKENS = 256, 256, 16


def init_loss(cfg) -> float:
    """The loss at init: ln V plus σ²/2 for logits of std σ = 0.02 ·
    sqrt(d_model) (a unit-RMS final norm times the lm_head's 0.02
    draws), the log-mean-exp of a normal."""
    return float(np.log(cfg.vocab_size) + (0.02 ** 2 * cfg.d_model) / 2)


def decode_launches(profile: str) -> str:
    """The launch count of ``profile_decode``'s line."""
    match = re.search(r"(\d+) launch calls", profile)
    return match.group(1) if match else "not measured"


def twice_ms(fn) -> tuple:
    """CUDA-event milliseconds of a first and a second call of ``fn``."""
    times = []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return tuple(times)


def model_rwkv() -> None:
    """(m5) rwkv6-1.6b at full size: ``loss_fn`` at batch 1, S =
    RWKV_SEQ (fp32 and bf16, one timed call each: ≈ 8 s, the wkv loop's
    ≈ 393 k launches), a prefill of RECURRENT_PROMPT and
    RECURRENT_STEPS decode steps held to ``forward_train`` at MODEL_TOL
    (fp32), ``generate`` timed at batch 4 with a decode step's launches
    under ``torch.profiler``."""
    from repro_torch.convert import model_params_to
    from repro_torch.models import Model

    cfg = model_config("rwkv6-1.6b", dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(29)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    log(f"model/rwkv6-1.6b: {cfg.num_layers} rwkv layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{sum(t.numel() for t in tree_leaves(params))} parameters, "
        f"{gib(params):.3f} GiB at fp32, init "
        f"{time.perf_counter() - t0:.2f} s; card {card_line()}")
    tok = torch.randint(2, cfg.vocab_size, (1, RWKV_SEQ + 1), device="cuda",
                        generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with torch.no_grad():
        for label, p, pcfg in (
                ("fp32", params, cfg),
                ("bf16", model_params_to(params, dtype=torch.bfloat16),
                 model_config("rwkv6-1.6b"))):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            loss = float(Model(pcfg).loss_fn(p, batch)[0])
            end.record()
            torch.cuda.synchronize()
            assert np.isfinite(loss) and abs(loss - init_loss(cfg)) < 0.1, \
                loss
            log(f"model/rwkv6-1.6b {label}: loss_fn (batch 1, S = "
                f"{RWKV_SEQ}, {RWKV_SEQ // 256} chunks of 256) "
                f"{start.elapsed_time(end):.4f} ms (CUDA events, one call), "
                f"loss {loss:.4f} (at init ln V + σ²/2 = "
                f"{init_loss(cfg):.4f}); card {card_line()}")
            del p
    torch.cuda.empty_cache()
    S, T = RECURRENT_PROMPT, RECURRENT_STEPS + 1
    prompts = torch.randint(2, cfg.vocab_size, (2, S), device="cuda",
                            generator=gen)
    t0 = time.perf_counter()
    d_pre, d_dec, _ = decode_consistency(cfg, model, params, prompts, T,
                                         tol=MODEL_TOL)
    log(f"model/generate rwkv6-1.6b: batch 2, prompt {S}, {T - 1} decode "
        f"steps: prefill logits max |diff| {d_pre:.3g} and the decode steps' "
        f"max |diff| {d_dec:.3g} vs forward_train on the {S + T - 1} tokens "
        f"(rtol = atol = {MODEL_TOL['rtol']:g}); every generated token the "
        f"decode loop's argmax ({time.perf_counter() - t0:.1f} s)")
    prompts = torch.randint(2, cfg.vocab_size, (GEN_BATCH, MOE_GEN_PROMPT),
                            device="cuda", generator=gen)
    for label, p, pcfg in (
            ("fp32", params, cfg),
            ("bf16", model_params_to(params, dtype=torch.bfloat16),
             model_config("rwkv6-1.6b"))):
        t = generate_times(Model(pcfg), p, prompts, GEN_TOKENS, reps=1)
        log(f"model/generate rwkv6-1.6b {label}: batch {GEN_BATCH}, prompt "
            f"{MOE_GEN_PROMPT}, {GEN_TOKENS} new tokens: prefill "
            f"{t['prefill_ms']:.4f} ms, generate {t['generate_ms']:.4f} ms, "
            f"{t['ms_per_token']:.4f} ms a decode step "
            f"({decode_launches(t['profile'])} launches), "
            f"{t['tokens_per_s']:.1f} tokens/s (CUDA events, one run after "
            f"two warm-ups); "
            f"{t['profile']}; card {card_line()}")
        del p
    del params
    torch.cuda.empty_cache()


def jamba_cut(slots: slice, **cut):
    """jamba-1.5-large-398b's period slots ``slots`` at full width."""
    from repro_torch.configs import get_config
    pattern = get_config("jamba-1.5-large-398b").pattern[slots]
    return model_config("jamba-1.5-large-398b", pattern=pattern,
                        num_layers=len(pattern), **cut)


def model_jamba() -> float:
    """(m6) jamba-1.5-large-398b cut to its period's first JAMBA_SLOTS
    slots (widths unchanged) at its bf16: ``loss_fn`` at batch 1, S =
    4096, timed, with its peak memory; ``generate`` timed at batch 4.
    Then the slots JAMBA_CHECK at fp32: prefill and JAMBA_STEPS decode
    steps held to ``forward_train`` at JAMBA_TOL with capacity C = T (no
    drops on either path).  Returns the ``loss_fn`` peak, GiB."""
    import dataclasses
    from repro_torch.models import Model

    cfg = jamba_cut(slice(0, JAMBA_SLOTS))
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(31)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    kinds = [f"{k}+{cfg.ffn_kind(i)}" for i, k in enumerate(cfg.pattern)]
    log(f"model/jamba-1.5-large-398b cut: slots {kinds} of the 8-slot period "
        f"(72 layers), d_model {cfg.d_model}, d_inner {cfg.mamba_d_inner}, "
        f"state {cfg.mamba_state}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} KV, {cfg.num_experts} experts top-"
        f"{cfg.top_k} at d_ff {cfg.d_ff}: "
        f"{sum(t.numel() for t in tree_leaves(params))} parameters, "
        f"{gib(params):.3f} GiB at bf16, init "
        f"{time.perf_counter() - t0:.2f} s; card {card_line()}")
    tok = torch.randint(2, cfg.vocab_size, (1, MODEL_SEQ + 1), device="cuda",
                        generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with torch.no_grad():
        loss = {}

        def run():
            out = model.loss_fn(params, batch)
            loss["v"], loss["nll"] = float(out[0]), float(out[1]["nll"])
        torch.cuda.reset_peak_memory_stats()
        first, second = twice_ms(run)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert np.isfinite(loss["v"]) and \
        abs(loss["nll"] - init_loss(cfg)) < 0.1, loss
    log(f"model/jamba-1.5-large-398b cut bf16: loss_fn (batch 1, S = "
        f"{MODEL_SEQ}) {first:.4f} / {second:.4f} ms (CUDA events, first and "
        f"second call), loss {loss['v']:.4f} (nll {loss['nll']:.4f}; at init "
        f"ln V + σ²/2 = {init_loss(cfg):.4f}), peak memory {peak:.2f} GiB; "
        f"card {card_line()}")
    torch.cuda.empty_cache()
    prompts = torch.randint(2, cfg.vocab_size, (GEN_BATCH, MOE_GEN_PROMPT),
                            device="cuda", generator=gen)
    t = generate_times(model, params, prompts, JAMBA_GEN_TOKENS)
    log(f"model/generate jamba-1.5-large-398b cut bf16: batch {GEN_BATCH}, "
        f"prompt {MOE_GEN_PROMPT}, {JAMBA_GEN_TOKENS} new tokens: prefill "
        f"{t['prefill_ms']:.4f} ms, generate {t['generate_ms']:.4f} ms, "
        f"{t['ms_per_token']:.4f} ms a decode step "
        f"({decode_launches(t['profile'])} launches), "
        f"{t['tokens_per_s']:.1f} tokens/s (CUDA events, medians of 3); "
        f"{t['profile']}; card {card_line()}")
    del params
    torch.cuda.empty_cache()
    cfg = jamba_cut(JAMBA_CHECK, dtype="float32")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                              / cfg.top_k)
    model = Model(cfg)
    params = model.init(gen)
    S, T = JAMBA_PROMPT, JAMBA_STEPS + 1
    prompts = torch.randint(2, cfg.vocab_size, (2, S), device="cuda",
                            generator=gen)
    t0 = time.perf_counter()
    d_pre, d_dec, _ = decode_consistency(cfg, model, params, prompts, T,
                                         tol=JAMBA_TOL)
    kinds = [f"{k}+{cfg.ffn_kind(i)}" for i, k in enumerate(cfg.pattern)]
    log(f"model/generate jamba-1.5-large-398b slots {kinds} fp32 "
        f"({gib(params):.3f} GiB): batch 2, prompt {S}, {T - 1} decode "
        f"steps, capacity factor {cfg.capacity_factor:g} (no drops): "
        f"prefill logits max |diff| {d_pre:.3g} and the decode steps' max "
        f"|diff| {d_dec:.3g} vs forward_train on the {S + T - 1} tokens "
        f"(rtol {JAMBA_TOL['rtol']:g}, atol {JAMBA_TOL['atol']:g}); every "
        f"generated token the decode loop's argmax "
        f"({time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()
    return peak


def phase_model() -> dict:
    """The decoder stack on the card: (m1)-(m6).  Returns the launches of
    K6 and K4 that the phase's counted runs made."""
    t0 = time.perf_counter()
    k6 = model_longformer()
    log(f"model: longformer part {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k4 = model_mixtral()
    log(f"model: mixtral part {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    peaks = {}
    for name, part in (("rwkv6-1.6b", model_rwkv),
                       ("jamba cut", model_jamba)):
        t0 = time.perf_counter()
        peaks[name] = part()
        log(f"model: {name} part {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model_reduced()
    log(f"model: reduced sweep {time.perf_counter() - t0:.1f} s")
    return {"attn_fused_staged": k6, "spmm_bcsr_fused_staged": k4,
            "jamba_peak_gib": peaks["jamba cut"]}


# the training path (k): AdamW steps of longformer-1.4b at full width,
# fp32, batch 1, S = TRAIN_SEQ under remat "full" (a warm-up, then the
# timed step); one rwkv6-1.6b step at
# S = RWKV_TRAIN_SEQ; run_training on reduced configs (RUN_STEPS steps,
# the resume from the step-RUN_STOP checkpoint); one step of every
# architecture at reduced(), card against CPU
TRAIN_SEQ, RWKV_TRAIN_SEQ, TRAIN_LR = 4096, 1024, 3e-4
RUN_ARCHS = ("longformer-1.4b", "rwkv6-1.6b", "jamba-1.5-large-398b")
RUN_STEPS, RUN_STOP, RUN_BATCH, RUN_SEQ = 6, 3, 2, 64
SWEEP_LR, SWEEP_EPS = 1e-3, 1e-8
# card against CPU: the same fp32 formulas on another device's products,
# whose sum orders differ in the last bits
SWEEP_TOL = dict(rtol=1e-4, atol=1e-4)


class _StepSpans:
    """CUDA events at the edges of a train step's parts: ``Model.loss_fn``
    (the forward), the optimizer's ``update`` (everything from its call
    to the step's end: the update and ``apply_updates``), and between
    them the backward."""

    def __init__(self, model):
        from repro_torch.optim import AdamW
        self.model, self.opt_cls = model, AdamW
        self.ev = {}

    def _event(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.ev[name] = ev

    def __enter__(self):
        loss_fn, update = self.model.loss_fn, self.opt_cls.update

        def timed_loss(*a, **kw):
            self._event("start")
            out = loss_fn(*a, **kw)
            self._event("forward")
            return out

        def timed_update(opt, *a, **kw):
            self._event("backward")
            return update(opt, *a, **kw)

        self.saved = update
        self.model.loss_fn = timed_loss
        self.opt_cls.update = timed_update
        return self

    def __exit__(self, *exc):
        del self.model.loss_fn
        self.opt_cls.update = self.saved
        return False

    def split(self) -> dict:
        self._event("end")
        torch.cuda.synchronize()
        e = self.ev
        parts = {"forward": e["start"].elapsed_time(e["forward"]),
                 "backward": e["forward"].elapsed_time(e["backward"]),
                 "optimizer": e["backward"].elapsed_time(e["end"])}
        parts["step"] = sum(parts.values())
        return parts


def train_step_at_size(arch: str, seq: int, steps: int) -> dict:
    """``steps`` ``make_train_step`` steps (AdamW, remat "full") of
    ``arch`` at full width, fp32, batch 1 over ``seq`` tokens of one
    batch, built as ``run_training`` builds its one-card step (the
    parameters and state sharded onto ``make_host_mesh(1, 1)``, the
    step given its ``shard_ctx`` and ``grad_shardings``), each from the
    initial params and optimizer state: the ones
    before the last warm up (plans, allocator; their results dropped,
    timed by the host clock), the last is timed by parts
    (``_StepSpans``), with its peak memory and its K6 launches (zeroed
    just before, read just after), no attention plain version run;
    every gradient finite, and the loss on the batch after the update
    under the loss before it."""
    from repro_torch import kernels
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.pytree import tree_leaves as leaves
    from repro_torch.train import make_train_step

    cfg = model_config(arch, dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(37)
    mesh = make_host_mesh(data=1, model=1)
    ctx = {"mesh": mesh, "dp": ("data",)}
    p_shard = sharding.param_shardings(model.param_shapes(), mesh)
    params = sharding.shard_tree(model.init(gen), p_shard)
    torch.cuda.empty_cache()
    opt = AdamW(learning_rate=TRAIN_LR)
    state = opt.init(params)
    tok = torch.randint(2, cfg.vocab_size, (1, seq + 1), device="cuda",
                        generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    finite = []

    def check(grads):
        finite.append(torch.stack([torch.isfinite(g).all()
                                   for g in leaves(grads)]).all())
        return grads

    step = make_train_step(model, opt, remat="full", shard_ctx=ctx,
                           grad_shardings=p_shard, grad_transform=check)
    warm = []
    for _ in range(steps - 1):
        t0 = time.perf_counter()
        metrics = step(params, state, batch)[2]
        warm.append(f"{time.perf_counter() - t0:.2f} s")
    k6 = kernels.attn_fused_staged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k6.launches = 0
    with _PlainCalls(("repro_torch.kernels.attn_fused", "_Carry")) as plain, \
            _StepSpans(model) as spans:
        params, state, metrics = step(params, state, batch)
        parts = spans.split()
    launches = k6.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    param_gib = sum(b.numel() * b.element_size()
                    for b in leaves(params)) / 2 ** 30
    metrics = {k: float(v) for k, v in metrics.items()}
    with torch.no_grad():
        after = float(model.loss_fn(params, batch, shard_ctx=ctx)[0])
    assert plain.calls == 0, plain.calls
    assert all(bool(f) for f in finite), "a gradient is not finite"
    assert np.isfinite(metrics["loss"]) and after < metrics["loss"], \
        (metrics, after)
    shares = ", ".join(f"{k} {parts[k]:.4f} ms ({100 * parts[k] / parts['step']:.1f}"
                       f" %)" for k in ("forward", "backward", "optimizer"))
    log(f"training/{arch} step (run_training's one-card (1, 1) mesh): "
        f"fp32, batch 1, S = {seq}, AdamW (lr "
        f"{TRAIN_LR:g}), remat full: {parts['step']:.4f} ms by CUDA events "
        f"= {shares}, call {steps} of {steps} (warm-ups by the host clock: "
        f"{', '.join(warm) or 'none'}); peak memory "
        f"{peak:.2f} GiB ({param_gib:.2f} GiB of params); {launches} "
        f"attn_fused_staged launches in the step, no attention plain "
        f"version; every gradient finite; loss {metrics['loss']:.4f} -> "
        f"{after:.4f} on the same batch after the update (grad norm "
        f"{metrics['grad_norm']:.4f}); card {card_line()}")
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": parts["step"], "peak_gib": peak}


class _Deterministic:
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` while
    active: index_add_, scatter_add_ and the gathers' backwards take
    their deterministic CUDA forms; the ops that have none only warn,
    and ``warned`` collects their messages."""

    def __enter__(self):
        import warnings
        self.before = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        self.catch = warnings.catch_warnings(record=True)
        self.records = self.catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self.catch.__exit__(*exc)
        torch.use_deterministic_algorithms(self.before)
        self.warned = sorted({str(r.message).split("\n")[0][:120]
                              for r in self.records
                              if "deterministic" in str(r.message)})
        return False


def train_runs() -> dict:
    """``run_training`` on the card for each of RUN_ARCHS at
    ``reduced()``: an uninterrupted RUN_STEPS-step run, then a run that
    stops at RUN_STOP with a checkpoint and one that resumes from it,
    whose losses and final params must be the uninterrupted run's bit
    for bit.  ``sparse_attn_preflight`` counted alone (one K6 launch);
    longformer's runs also take the SpMM shard preflight on one chip
    (K8 over K3).  Returns the phase's K6, K8 and K3 launches."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.ft.watchdog import Watchdog
    from repro_torch.launch import train
    from repro_torch.pytree import tree_leaves as leaves

    k6, k8 = kernels.attn_fused_staged, kernels.spmm_ell_fused_sharded
    k3 = kernels.spmm_ell_fused_staged
    counts = {"attn_fused_staged": 0, "spmm_ell_fused_sharded": 0,
              "spmm_ell_fused_staged": 0}
    cfg = reduced(get_config("longformer-1.4b"))
    k6.launches = 0
    train.sparse_attn_preflight(cfg, RUN_SEQ)
    assert k6.launches == 1, k6.launches
    counts["attn_fused_staged"] += 1
    for arch in RUN_ARCHS:
        cfg = reduced(get_config(arch))
        t0 = time.perf_counter()
        kw = dict(steps=RUN_STEPS, global_batch=RUN_BATCH, seq_len=RUN_SEQ,
                  log_every=RUN_STEPS, spmm_chips=int(arch == RUN_ARCHS[0]))
        k6.launches = k8.launches = k3.launches = 0
        with tempfile.TemporaryDirectory() as tmp, _Deterministic() as det:
            # a generous deadline: this run checks the resume, not the
            # watchdog, which the CPU tests drive on a fake clock
            full_p, full = train.run_training(
                cfg, watchdog=Watchdog(min_deadline_s=600), **kw)
            _, first = train.run_training(
                cfg, stop_at=RUN_STOP, ckpt_dir=tmp, ckpt_every=100,
                watchdog=Watchdog(min_deadline_s=600), **kw)
            res_p, rest = train.run_training(
                cfg, ckpt_dir=tmp, ckpt_every=100,
                watchdog=Watchdog(min_deadline_s=600), **kw)
        same = all(torch.equal(a, b) for a, b in zip(leaves(full_p),
                                                     leaves(res_p)))
        log(f"training/run_training {cfg.name}: {RUN_STEPS} steps at batch "
            f"{RUN_BATCH}, S = {RUN_SEQ}: losses {[f'{v:.6f}' for v in full]};"
            f" stopped at {RUN_STOP} and resumed: "
            f"{'bit for bit' if first + rest == full else 'DIFFERENT'} "
            f"losses, params {'bit for bit' if same else 'DIFFERENT'}; "
            f"launches K6 {k6.launches}, K8 {k8.launches}, K3 {k3.launches}; "
            f"ops without a deterministic CUDA form: {det.warned or 'none'} "
            f"({time.perf_counter() - t0:.1f} s)")
        assert first + rest == full and same, cfg.name
        assert full[-1] < full[0], full
        counts["attn_fused_staged"] += k6.launches
        counts["spmm_ell_fused_sharded"] += k8.launches
        counts["spmm_ell_fused_staged"] += k3.launches
        if "sattn" in cfg.pattern:
            assert k6.launches > 0
        del full_p, res_p
    return counts


def train_sweep() -> None:
    """One ``make_train_step`` step of every architecture at ``reduced()``,
    the same weights and batch on the card and the CPU: loss and grad
    norm at SWEEP_TOL, every gradient at SWEEP_TOL, the updated params at
    SWEEP_TOL where the clipped gradient |g'| >= 10 eps and within 2 lr
    elsewhere (AdamW's first step moves an element by lr · g' / (|g'| +
    eps), which a last-bit difference in a g' near 0 can flip)."""
    from repro_torch.configs import all_arch_names, get_config, reduced
    from repro_torch.convert import model_params_to
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.pytree import tree_leaves as leaves
    from repro_torch.train import make_train_step
    worst = {}
    for seed, arch in enumerate(all_arch_names()):
        cfg = reduced(get_config(arch))
        model = Model(cfg)
        cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
        batch = TokenPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=32, global_batch=2, seed=seed,
            num_image_tokens=cfg.num_image_tokens
            if cfg.family == "vlm" else 0, d_model=cfg.d_model)).batch_at(0)
        runs = {}
        for device, params in (("cpu", cpu),
                               ("cuda", model_params_to(cpu, device="cuda"))):
            grads = []

            def keep(g):
                grads.append(g)
                return g
            opt = AdamW(learning_rate=SWEEP_LR, eps=SWEEP_EPS)
            step = make_train_step(model, opt, chunk_q=32,
                                   grad_transform=keep, device=device)
            new, _, metrics = step(params, opt.init(params), batch)
            runs[device] = ([t.cpu() for t in leaves(new)],
                            [g.cpu() for g in leaves(grads[0])],
                            {k: float(v) for k, v in metrics.items()})
        (p_cpu, g_cpu, m_cpu), (p_gpu, g_gpu, m_gpu) = runs["cpu"], \
            runs["cuda"]
        for k in ("loss", "grad_norm", "nll"):
            np.testing.assert_allclose(m_gpu[k], m_cpu[k], **SWEEP_TOL)
        d_g = max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu))
        for a, b in zip(g_gpu, g_cpu):
            torch.testing.assert_close(a, b, **SWEEP_TOL)
        scale = min(1.0, 1.0 / (m_cpu["grad_norm"] + 1e-9))
        d_firm = d_soft = 0.0
        for a, b, g in zip(p_gpu, p_cpu, g_cpu):
            diff = (a - b).abs()
            firm = g.abs() * scale >= 10 * SWEEP_EPS
            if firm.any():
                bound = SWEEP_TOL["atol"] + SWEEP_TOL["rtol"] * b.abs()
                assert bool((diff[firm] <= bound[firm]).all()), arch
                d_firm = max(d_firm, diff[firm].max().item())
            if (~firm).any():
                assert bool((diff[~firm] <= 2 * SWEEP_LR + 1e-5).all()), arch
                d_soft = max(d_soft, diff[~firm].max().item())
        worst[arch] = (abs(m_gpu["loss"] - m_cpu["loss"]),
                       abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]), d_g,
                       d_firm, d_soft)
    log(f"training/reduced sweep: {len(worst)} architectures, one AdamW step "
        f"each (batch 2, S = 32), card vs CPU max |diff| of loss, grad norm, "
        f"grads, params where |g'| >= 10 eps, params elsewhere: "
        + "; ".join(f"{a} " + " ".join(f"{v:.3g}" for v in d)
                    for a, d in worst.items())
        + f" (rtol = atol = {SWEEP_TOL['rtol']:g}; elsewhere within "
        f"2 lr = {2 * SWEEP_LR:g})")


def phase_training(jamba_peak: float) -> dict:
    """(k) the training path on the card, then (l) the mesh.  Returns the
    phase's launches of K6, K8 and K3, the longformer step's numbers and
    the mesh step's."""
    t0 = time.perf_counter()
    step = train_step_at_size("longformer-1.4b", TRAIN_SEQ, 2)
    assert step["launches"] >= 384 and step["launches"] % 384 == 0, step
    log(f"training: longformer-1.4b step part {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # one step: the wkv loop's ≈ 0.5 M launches and their autograd nodes
    # take ≈ 47 s of host time a step at S = 1024
    train_step_at_size("rwkv6-1.6b", RWKV_TRAIN_SEQ, 1)
    log(f"training: rwkv6-1.6b step part {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts = train_runs()
    log(f"training: run_training part {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_sweep()
    log(f"training: reduced sweep {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh(jamba_peak)
    counts["attn_fused_staged"] += step["launches"] + \
        mesh["attn_fused_staged"]
    return {"launches": counts, "step": step, "mesh": mesh["step"]}


# the mesh (l): longformer-1.4b at full width, fp32, S = MESH_SEQ, global
# batch MESH_BATCH, remat full, one AdamW step on make_host_mesh(data=2,
# model=2) -- four chips on the card -- against the unsharded step at
# microbatches=2 from the same weights, state and batch (l1); every
# architecture at reduced(), a sharded step on the card against the
# card's unsharded microbatches=2 step and the CPU's sharded step (l2);
# run_training on reduced longformer at (2, 2), stopped at RUN_STOP and
# resumed on (2, 2) and on (2, 1) (l3); compressed_psum over four chips
# of the card against four CPU chips (l4); the dry run's card records
# beside the peaks measured (l5).  Sharded params and moments are 20.3
# GiB in all; the unsharded step's initial weights wait on the host
# meanwhile.  Each data group runs its two model chips (the Megatron
# split): each chip its 8 of the 16 heads and 4096 of the 8192 d_ff
# columns, the partial sums added on the card
MESH_SEQ, MESH_BATCH, MESH_SHAPE = 4096, 2, (2, 2)
# the split's partial sums add in another order than the whole
# products: loss, grad norm, moments held at rtol = atol = MESH_TOL to
# the unsharded step, the parameters by tests/test_torch_mesh_step_ref.py's
# rule (MESH_TOL where the clipped gradient |g'| >= 10 eps, 2 lr elsewhere)
MESH_TOL = 1e-5
MESH_SWEEP_SEQ = 32
GATHER = ("repro_torch.distributed.sharding", "gather_slice")


def _host(tree):
    """Every leaf of a (sharded) tree gathered whole onto the CPU."""
    from repro_torch.distributed.sharding import gather_tree
    return gather_tree(tree, "cpu")


def _leaf_diffs(got, want) -> tuple:
    """(leaves equal bit for bit, of how many; the largest max|a-b| /
    max|b| over the leaves), each leaf of ``want`` (on the CPU) moved to
    ``got``'s device, one at a time, and compared there."""
    from repro_torch.pytree import tree_leaves as leaves
    same, worst, n = 0, 0.0, 0
    for a, b in zip(leaves(got), leaves(want)):
        b = b.to(a.device)
        n += 1
        if torch.equal(a, b):
            same += 1
            continue
        top = float(b.float().abs().max())
        worst = max(worst, float((a.float() - b.float()).abs().max())
                    / (top or 1.0))
    return same, n, worst


def _rule_check(got_p, p_u, mu_u, lr: float, eps: float,
                b1: float) -> float:
    """The parameter rule on the card, leaf by leaf: within MESH_TOL
    where the unsharded step's clipped gradient (its first moment over
    1 - b1, a first step's) |g'| >= 10 eps, within 2 lr elsewhere.
    Returns the largest firm |diff|; raises where the rule fails."""
    from repro_torch.pytree import tree_leaves as leaves
    worst = 0.0
    for a, b, m in zip(leaves(got_p), leaves(p_u), leaves(mu_u)):
        a = a.to(b.device)
        diff = (a - b).abs()
        firm = m.abs() / (1 - b1) >= 10 * eps
        assert bool((diff[firm] <= MESH_TOL + MESH_TOL * b.abs()[firm])
                    .all()), "firm parameters off"
        assert bool((diff[~firm] <= 2 * lr + MESH_TOL).all())
        if firm.any():
            worst = max(worst, float(diff[firm].max()))
    return worst


def _moments_close(got, want) -> None:
    from repro_torch.pytree import tree_leaves as leaves
    for a, b in zip(leaves(got), leaves(want)):
        torch.testing.assert_close(a.to(b.device), b, rtol=MESH_TOL,
                                   atol=MESH_TOL)


class _MeshSpans(_Spans):
    """CUDA events around every ``Model.loss_fn`` call (one a data group:
    its forward and backward run from it to the next group's start), the
    optimizer's ``update`` and the stack's parameter gathers."""

    def __init__(self, model):
        from repro_torch.optim import AdamW
        super().__init__(GATHER)
        self.model, self.opt_cls = model, AdamW
        self.marks = []

    def _mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def __enter__(self):
        super().__enter__()
        loss_fn, update = self.model.loss_fn, self.opt_cls.update

        def timed_loss(*a, **kw):
            self._mark("group")
            return loss_fn(*a, **kw)

        def timed_update(opt, *a, **kw):
            self._mark("optimizer")
            return update(opt, *a, **kw)

        self.saved_update = update
        self.model.loss_fn = timed_loss
        self.opt_cls.update = timed_update
        return self

    def __exit__(self, *exc):
        del self.model.loss_fn
        self.opt_cls.update = self.saved_update
        return super().__exit__(*exc)

    def split(self) -> dict:
        self._mark("end")
        torch.cuda.synchronize()
        parts, groups = {}, 0
        for (name, ev), (_, nxt) in zip(self.marks, self.marks[1:]):
            if name == "group":
                name, groups = f"group {groups}", groups + 1
            parts[name] = ev.elapsed_time(nxt)
        parts["gathers"] = self.ms(GATHER)
        parts["step"] = self.marks[0][1].elapsed_time(self.marks[-1][1])
        return parts


def l1_inputs() -> tuple:
    """(l1)'s configuration, model, seeded weights on the card and
    batch: longformer-1.4b at full width, fp32, MESH_BATCH x MESH_SEQ."""
    from repro_torch.models import Model
    cfg = model_config("longformer-1.4b", dtype="float32")
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(41)
    params = model.init(gen)
    tok = torch.randint(2, cfg.vocab_size, (MESH_BATCH, MESH_SEQ + 1),
                        device="cuda", generator=gen)
    return cfg, model, params, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def mesh_step_at_size() -> dict:
    """(l1) one sharded AdamW step of longformer-1.4b at full width on a
    (2, 2) mesh of the card's chips, each data group split over its two
    model chips, against the unsharded step at microbatches=2 from the
    same initial weights, state and batch, both under deterministic
    algorithms: loss and grad norm at MESH_TOL, the moments at MESH_TOL,
    the parameters by the rule.  Times by data group and by model chip,
    the gathers', the model-axis sums' and the optimizer's (CUDA
    events), the peak memory, the bytes each chip holds and gathers a
    period, and the K6 launches of the sharded step by chip (zeroed just
    before, read just after)."""
    from repro_torch import kernels
    from repro_torch.distributed import sharding
    from repro_torch.distributed.model_split import SplitTally
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    cfg, model, params, batch = l1_inputs()
    initial = _host(params)                 # the unsharded step's start
    mesh = make_host_mesh(data=MESH_SHAPE[0], model=MESH_SHAPE[1])
    p_shard = sharding.param_shardings(model.param_shapes(), mesh)
    sp = sharding.shard_tree(params, p_shard)
    del params
    torch.cuda.empty_cache()
    opt = AdamW(learning_rate=TRAIN_LR)
    state = opt.init(sp)
    sbatch = sharding.shard_tree(batch, sharding.batch_shardings(batch,
                                                                  mesh))
    resident = [a + b + c for a, b, c in zip(
        sharding.chip_bytes(sp, mesh), sharding.chip_bytes(state.mu, mesh),
        sharding.chip_bytes(state.nu, mesh))]
    # the embedding, final norm and head: whole (vocab 50265 does not
    # split), gathered once a group by its first model chip
    top = sum(math.prod(sp[k].shape) * 4
              for k in ("embed", "final_norm", "lm_head"))
    tally = SplitTally(mesh, timed=True)
    step = make_train_step(model, opt, remat="full",
                           shard_ctx={"mesh": mesh, "dp": ("data",),
                                      "tally": tally},
                           grad_shardings=p_shard)
    k6 = kernels.attn_fused_staged
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k6.launches = 0
    with _Deterministic() as det, \
            _PlainCalls(("repro_torch.kernels.attn_fused", "_Carry")) as plain, \
            _MeshSpans(model) as spans:
        sp, state, metrics = step(sp, state, sbatch)
        parts = spans.split()
    launches = k6.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m_s = {k: float(v) for k, v in metrics.items()}
    (chip_fwd, chip_bwd), sum_ms = tally.chip_ms(), tally.sum_ms()
    chip_ms = [f + b for f, b in zip(chip_fwd, chip_bwd)]
    assert plain.calls == 0, plain.calls
    firsts = {c for c in range(mesh.size) if mesh.coords(c)["model"] == 0}
    # each chip's gathers a period: a forward and a recompute a period
    per_period = [(b - (top if c in firsts else 0)) / (2 * cfg.num_periods)
                  for c, b in enumerate(tally.gathered)]
    t_moves = time.perf_counter()
    got_p, got_mu, got_nu = _host(sp), _host(state.mu), _host(state.nu)
    del sp, state, metrics
    torch.cuda.empty_cache()
    params = _to_card(initial)
    state_u = opt.init(params)
    ref = make_train_step(model, opt, remat="full", microbatches=2)
    moves = time.perf_counter() - t_moves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _Deterministic():
        params, state_u, metrics = ref(params, state_u, batch)
        m_u = {k: float(v) for k, v in metrics.items()}
    ref_s = time.perf_counter() - t0
    peak_u = torch.cuda.max_memory_allocated() / 2 ** 30
    diffs = {name: _leaf_diffs(a, b) for name, a, b in (
        ("params", params, got_p), ("mu", state_u.mu, got_mu),
        ("nu", state_u.nu, got_nu))}
    d_loss = abs(m_s["loss"] - m_u["loss"])
    d_norm = abs(m_s["grad_norm"] - m_u["grad_norm"])
    groups = ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()
                       if k.startswith("group"))
    in_groups = sum(v for k, v in parts.items() if k.startswith("group"))
    log(f"mesh/l1 longformer-1.4b sharded step on a {MESH_SHAPE} mesh of "
        f"{mesh.size} chips on {mesh.devices[0]}, the model axis splitting "
        f"heads and d_ff: fp32, global batch {MESH_BATCH}, S = {MESH_SEQ}, "
        f"AdamW (lr {TRAIN_LR:g}), remat full, deterministic algorithms: "
        f"step {parts['step']:.4f} ms by CUDA events = {groups} (forward + "
        f"backward each), optimizer {parts['optimizer']:.4f} ms; by model "
        f"chip (CUDA events around each chip's part of every block, and in "
        f"the backward at each point where the gradient of a leaf part it "
        f"took completes): forward and recompute "
        f"{[round(v, 4) for v in chip_fwd]} ms, backward "
        f"{[round(v, 4) for v in chip_bwd]} ms, in all "
        f"{[round(v, 4) for v in chip_ms]} ms; the groups outside the "
        f"chips' parts (norms, residuals, embedding, the sums) "
        f"{in_groups - sum(chip_ms):.4f} ms; model-axis sums "
        f"{tally.sums} ({sum_ms:.4f} ms in all, within the groups); "
        f"parameter gathers {parts['gathers']:.4f} ms in all "
        f"({len(spans.spans[GATHER])} gather_slice calls, within the "
        f"groups); bytes gathered a chip a period "
        f"{[round(b / 1e6, 3) for b in per_period]} MB (the embedding, "
        f"final norm and head, {top / 1e6:.1f} MB, once a group besides); "
        f"K6 launches by chip {tally.attn} ({sum(tally.attn)} in all, "
        f"{launches} counted by the wrapper); peak memory {peak:.2f} GiB; "
        f"resident per chip (params + moments) "
        f"{[round(b / 2 ** 30, 3) for b in resident]} GiB, "
        f"{sum(resident) / 2 ** 30:.3f} GiB over the chips; no attention "
        f"plain version; ops without a deterministic CUDA form: "
        f"{det.warned or 'none'}; card {card_line()}")
    firm = _rule_check(got_p, params, state_u.mu, TRAIN_LR, opt.eps,
                       opt.b1)
    _moments_close(got_mu, state_u.mu)
    _moments_close(got_nu, state_u.nu)
    log(f"mesh/l1 against the unsharded step at microbatches=2 "
        f"({ref_s:.2f} s by the host clock, peak {peak_u:.2f} GiB; the "
        f"sharded results to the host and the initial weights back "
        f"{moves:.1f} s): loss {m_s['loss']!r} vs {m_u['loss']!r} (|diff| "
        f"{d_loss:.3g}); grad norm {m_s['grad_norm']!r} vs "
        f"{m_u['grad_norm']!r} (|diff| {d_norm:.3g}); leaves bit for bit: "
        + "; ".join(f"{k} {s_} of {n} (largest max|diff|/max|leaf| of the "
                    f"rest {w:.3g})" for k, (s_, n, w) in diffs.items())
        + f"; moments within rtol = atol = {MESH_TOL:g}, parameters by the "
        f"rule (largest firm |diff| {firm:.3g})")
    for k in ("loss", "grad_norm"):
        assert np.isfinite(m_s[k]) and abs(m_s[k] - m_u[k]) <= \
            MESH_TOL + MESH_TOL * abs(m_u[k]), (k, m_s, m_u)
    assert launches == sum(tally.attn) == MESH_SHAPE[0] * 2 * 384, launches
    assert tally.attn == [384] * mesh.size, tally.attn
    del params, state_u, metrics, initial, got_p, got_mu, got_nu
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": parts["step"], "peak_gib": peak,
            "resident": resident, "cfg": cfg, "per_chip": tally.attn,
            "gathered": per_period, "sums": tally.sums, "sum_ms": sum_ms}


def _to_card(tree):
    from repro_torch.pytree import tree_map
    return tree_map(lambda t: t.to("cuda"), tree)


def mesh_sweep() -> int:
    """(l2) one sharded step of every architecture at ``reduced()`` on a
    (2, 2) mesh of the card, against the card's unsharded microbatches=2
    step and the CPU's sharded step (the same weights and batch), at
    SWEEP_TOL (params: where |g'| >= 10 eps; within 2 lr elsewhere).
    Returns its K6 launches."""
    from repro_torch import kernels
    from repro_torch.configs import all_arch_names, get_config, reduced
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.optim import AdamW
    from repro_torch.pytree import tree_leaves as leaves
    from repro_torch.train import make_train_step

    k6 = kernels.attn_fused_staged
    launches = 0
    worst, exact = {}, []
    for seed, arch in enumerate(all_arch_names()):
        cfg = reduced(get_config(arch))
        model = Model(cfg)
        cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
        batch = TokenPipeline(PipelineConfig(
            vocab_size=cfg.vocab_size, seq_len=MESH_SWEEP_SEQ,
            global_batch=MESH_BATCH, seed=seed,
            num_image_tokens=cfg.num_image_tokens
            if cfg.family == "vlm" else 0, d_model=cfg.d_model)).batch_at(0)
        runs = {}
        for name, device, sharded in (("card", "cuda", True),
                                      ("card mb2", "cuda", False),
                                      ("cpu", "cpu", True)):
            opt = AdamW(learning_rate=SWEEP_LR, eps=SWEEP_EPS)
            grads = []

            def keep(g):
                grads.append(g)
                return g
            params = cpu if device == "cpu" else _to_card(cpu)
            if sharded:
                mesh = make_host_mesh(data=MESH_SHAPE[0],
                                      model=MESH_SHAPE[1], device=device)
                params = sharding.shard_tree(params, sharding.param_shardings(
                    model.param_shapes(), mesh))
                step = make_train_step(model, opt, chunk_q=MESH_SWEEP_SEQ,
                                       grad_transform=keep,
                                       shard_ctx={"mesh": mesh,
                                                  "dp": ("data",)})
            else:
                step = make_train_step(model, opt, chunk_q=MESH_SWEEP_SEQ,
                                       microbatches=2, grad_transform=keep,
                                       device=device)
            before = k6.launches
            with _Deterministic():
                new, _, metrics = step(params, opt.init(params), batch)
            if name == "card":
                launches += k6.launches - before
            runs[name] = ([t for t in leaves(_host(new))],
                          [g for g in leaves(_host(grads[0]))],
                          {k: float(v) for k, v in metrics.items()})
        p_ref, g_ref, m_ref = runs["card"]
        exact.append(runs["card"][2]["loss"] == runs["card mb2"][2]["loss"])
        row = []
        for other in ("card mb2", "cpu"):
            p_o, g_o, m_o = runs[other]
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(m_ref[k], m_o[k], **SWEEP_TOL)
            for a, b in zip(g_ref, g_o):
                torch.testing.assert_close(a, b, **SWEEP_TOL)
            scale = min(1.0, 1.0 / (m_o["grad_norm"] + 1e-9))
            d_firm = 0.0
            for a, b, g in zip(p_ref, p_o, g_o):
                diff = (a - b).abs()
                firm = g.abs() * scale >= 10 * SWEEP_EPS
                bound = SWEEP_TOL["atol"] + SWEEP_TOL["rtol"] * b.abs()
                assert bool((diff[firm] <= bound[firm]).all()), (arch, other)
                assert bool((diff[~firm] <= 2 * SWEEP_LR + 1e-5).all()), \
                    (arch, other)
                if firm.any():
                    d_firm = max(d_firm, diff[firm].max().item())
            row += [abs(m_ref["loss"] - m_o["loss"]), d_firm]
        worst[arch] = row
    log(f"mesh/l2 reduced sweep: {len(worst)} architectures, one AdamW step "
        f"each (global batch {MESH_BATCH}, S = {MESH_SWEEP_SEQ}) on a "
        f"{MESH_SHAPE} mesh of the card, deterministic algorithms; loss bit "
        f"for bit with the card's unsharded microbatches=2 step in "
        f"{sum(exact)} of {len(exact)}; max |diff| of loss and firm params vs "
        f"the card's microbatches=2 step, then vs the CPU's sharded step: "
        + "; ".join(f"{a} " + " ".join(f"{v:.3g}" for v in d)
                    for a, d in worst.items())
        + f" (rtol = atol = {SWEEP_TOL['rtol']:g}; {launches} K6 launches)")
    return launches


def mesh_runs() -> int:
    """(l3) ``run_training`` on reduced longformer at --dp 2 --tp 2 for
    RUN_STEPS steps, and stopped at RUN_STOP with a checkpoint, then
    resumed on the same (2, 2) mesh (bit for bit the uninterrupted run)
    and on a (2, 1) mesh: the data grouping is the same, but the model
    axis no longer splits heads, d_ff and vocabulary, so the resumed
    losses are held at MESH_TOL and the final parameters by the rule,
    firm where the uninterrupted run's last clipped gradient |g'| >= 10
    eps.  Returns its K6 launches."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs import get_config, reduced
    from repro_torch.ft.watchdog import Watchdog
    from repro_torch.launch import train

    k6 = kernels.attn_fused_staged
    cfg = reduced(get_config("longformer-1.4b"))
    kw = dict(steps=RUN_STEPS, global_batch=RUN_BATCH, seq_len=RUN_SEQ,
              log_every=RUN_STEPS)
    # the uninterrupted run's last gradients and grad norm, for the rule
    last, make = {}, train.make_train_step

    def kept(*args, **kwargs):
        step = make(*args, grad_transform=lambda g: last.update(grads=g)
                    or g, **kwargs)

        def run(params, state, batch):
            params, state, metrics = step(params, state, batch)
            last["norm"] = float(metrics["grad_norm"])
            return params, state, metrics
        return run
    k6.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _Deterministic() as det:
        train.make_train_step = kept
        try:
            full_p, full = train.run_training(
                cfg, data_parallel=2, model_parallel=2,
                watchdog=Watchdog(min_deadline_s=600), **kw)
        finally:
            train.make_train_step = make
        _, first = train.run_training(
            cfg, data_parallel=2, model_parallel=2, stop_at=RUN_STOP,
            ckpt_dir=f"{tmp}/a", ckpt_every=100,
            watchdog=Watchdog(min_deadline_s=600), **kw)
        shutil.copytree(f"{tmp}/a", f"{tmp}/b")
        same_p, same = train.run_training(
            cfg, data_parallel=2, model_parallel=2, ckpt_dir=f"{tmp}/b",
            ckpt_every=100, watchdog=Watchdog(min_deadline_s=600), **kw)
        res_p, rest = train.run_training(
            cfg, data_parallel=2, model_parallel=1, ckpt_dir=f"{tmp}/a",
            ckpt_every=100, watchdog=Watchdog(min_deadline_s=600), **kw)
    full_host = _host(full_p)
    same_leaves = _leaf_diffs(same_p, full_host)
    moved = _leaf_diffs(res_p, full_host)
    # the parameter rule: MESH_TOL where the uninterrupted run's last
    # clipped gradient |g'| >= 10 eps, else 2 lr a step over the steps
    # run apart (run_training's lr peaks at 3e-4)
    scale = min(1.0, 1.0 / (last["norm"] + 1e-9))
    firm_n = loose_n = 0
    firm_worst = apart = 0.0
    for a, b, g in zip(tree_leaves(_host(res_p)), tree_leaves(full_host),
                       tree_leaves(_host(last["grads"]))):
        firm = g.abs() * scale >= 10 * 1e-8
        diff = (a - b).abs()
        assert bool((diff[firm] <= MESH_TOL + MESH_TOL * b.abs()[firm])
                    .all()), "firm parameters off"
        assert bool((diff[~firm] <= 2 * 3e-4 * (RUN_STEPS - RUN_STOP)
                     + MESH_TOL).all()), "parameters off"
        firm_n += int(firm.sum())
        loose_n += int((~firm).sum())
        if firm.any():
            firm_worst = max(firm_worst, float(diff[firm].max()))
        if not firm.all():
            apart = max(apart, float(diff[~firm].max()))
    d_loss = max(abs(a - b) for a, b in zip(first + rest, full))
    log(f"mesh/l3 run_training {cfg.name} at (2, 2): {RUN_STEPS} steps at "
        f"batch {RUN_BATCH}, S = {RUN_SEQ}: losses "
        f"{[f'{v:.6f}' for v in full]}; stopped at {RUN_STOP} and resumed "
        f"on (2, 2): {'bit for bit' if first + same == full else 'DIFFERENT'}"
        f" losses, final params bit for bit in {same_leaves[0]} of "
        f"{same_leaves[1]} leaves; resumed on (2, 1): losses |diff| "
        f"{d_loss:.3g} (held at rtol = atol = {MESH_TOL:g}), final params "
        f"bit for bit in {moved[0]} of {moved[1]} leaves (largest "
        f"max|diff|/max|leaf| {moved[2]:.3g}), by the rule: {firm_n} firm "
        f"elements (largest |diff| {firm_worst:.3g}, held at rtol = atol "
        f"= {MESH_TOL:g}), {loose_n} others (largest |diff| {apart:.3g}, "
        f"held at 2 lr a step); {k6.launches} K6 launches; "
        f"ops without a deterministic CUDA form: {det.warned or 'none'} "
        f"({time.perf_counter() - t0:.1f} s)")
    assert first + same == full and same_leaves[0] == same_leaves[1], \
        (first, same, full)
    assert first == full[:RUN_STOP]
    np.testing.assert_allclose(first + rest, full, rtol=MESH_TOL,
                               atol=MESH_TOL)
    assert full[-1] < full[0], full
    return k6.launches


def mesh_psum() -> None:
    """(l4) ``compressed_psum`` over four chips of the card: each
    participant's int8 payload and scale bit for bit the same call's on
    four CPU chips, every chip's sum the same, within the reference's
    bound C · scale · 0.51 of the float32 sum."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(43)
    C = 4
    parts = [torch.from_numpy((rng.standard_normal((4096, 1024)) * (1 + c))
                              .astype(np.float32)) for c in range(C)]
    card = collectives.int8_wire([p.cuda() for p in parts])
    host = collectives.int8_wire(parts)
    same = all(torch.equal(q.cpu(), hq) and torch.equal(s.cpu(), hs)
               for (q, s), (hq, hs) in zip(card, host))
    sums = collectives.compressed_psum(
        [p.cuda() for p in parts], make_host_mesh(data=C, model=1),
        axis="data")
    want = torch.stack(parts).sum(0)
    bound = sum(float(p.abs().max()) / 127.0 for p in parts) * 0.51
    err = float((sums[0].cpu() - want).abs().max())
    cpu_sum = collectives.compressed_psum(
        parts, make_host_mesh(data=C, model=1, device="cpu"),
        axis="data")[0]
    log(f"mesh/l4 compressed_psum over {C} chips of the card, parts of "
        f"{tuple(parts[0].shape)}: int8 payloads and scales "
        f"{'bit for bit' if same else 'DIFFERENT'} the CPU chips'; every "
        f"chip's sum {'the same' if all(torch.equal(s, sums[0]) for s in sums) else 'DIFFERENT'}"
        f", max |sum - float32 sum| {err:.4g} within C·scale·0.51 = "
        f"{bound:.4g}; card sum vs CPU chips' sum max |diff| "
        f"{float((sums[0].cpu() - cpu_sum).abs().max()):.3g}")
    assert same and err <= bound + 1e-6
    assert all(torch.equal(s, sums[0]) for s in sums)


def mesh_dryrun(l1: dict, jamba_peak: float) -> None:
    """(l5) the dry run's ``card`` records (meta device) beside the
    peaks the card measured: longformer-1.4b at train_4k and at (l1)'s
    own configuration and batch, its per-chip bytes on (l1)'s mesh, and
    the jamba cut's forward at (m6)'s batch and sequence."""
    import dataclasses
    from repro_torch.configs import ShapeSpec
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    from repro_torch.optim import AdamW

    def gib_(b):
        return b / 2 ** 30

    rec = dryrun.dryrun_cell("longformer-1.4b", "train_4k", "card")
    own = dryrun.dryrun_cell(
        "longformer-1.4b", "l1", "card", cfg=l1["cfg"],
        shape=ShapeSpec("l1", MESH_SEQ, MESH_BATCH, "train"))
    meta = sharding.LogicalMesh(("data", "model"), MESH_SHAPE,
                                ("meta",) * (MESH_SHAPE[0] * MESH_SHAPE[1]))
    model = Model(l1["cfg"])
    shapes = model.param_shapes()
    opt = AdamW().init(shapes)
    per_chip = sharding.placed_bytes(
        shapes, sharding.param_shardings(shapes, meta)) + 2 * \
        sharding.placed_bytes(opt.mu, sharding.param_shardings(opt.mu, meta))
    cut = jamba_cut(slice(0, JAMBA_SLOTS))
    jam = dryrun.dryrun_cell(
        "jamba-1.5-large-398b", "m6", "card", cfg=cut,
        shape=ShapeSpec("m6", MODEL_SEQ, 1, "prefill"))
    for r in (rec, own, jam):
        assert r["status"] == "ok", r
    log(f"mesh/l5 dry run (meta device, card mesh): longformer-1.4b "
        f"train_4k (bf16, batch 256) arguments "
        f"{gib_(rec['argument_bytes_per_chip']):.3f} GiB "
        f"({ {k: round(gib_(v), 3) for k, v in rec['breakdown'].items()} }), "
        f"bottleneck {rec['bottleneck']}, arguments fit the card: "
        f"{rec['arguments_fit_card']}; "
        f"(l1)'s configuration (fp32, batch {MESH_BATCH}, S = {MESH_SEQ}) "
        f"arguments {gib_(own['argument_bytes_per_chip']):.3f} GiB, memory "
        f"term {own['memory_s']:.4f} s, compute term {own['compute_s']:.4f} s"
        f" at the card's rates, against the measured peak "
        f"{l1['peak_gib']:.2f} GiB; on its {MESH_SHAPE} mesh "
        f"{gib_(per_chip):.3f} GiB a chip predicted, "
        f"{gib_(max(l1['resident'])):.3f} GiB measured; the jamba cut (bf16,"
        f" batch 1, S = {MODEL_SEQ}, forward) arguments "
        f"{gib_(jam['argument_bytes_per_chip']):.3f} GiB against the (m6) "
        f"loss_fn peak {jamba_peak:.2f} GiB (predictions, no gate)")
    assert per_chip == max(l1["resident"]), (per_chip, l1["resident"])


def phase_mesh(jamba_peak: float) -> dict:
    """(l) the mesh on the card.  Returns its K6 launches and (l1)'s
    numbers."""
    t_part = time.perf_counter()
    t0 = time.perf_counter()
    l1 = mesh_step_at_size()
    log(f"mesh: l1 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k6 = l1["launches"] + mesh_sweep()
    log(f"mesh: l2 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k6 += mesh_runs()
    log(f"mesh: l3 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mesh_psum()
    mesh_dryrun(l1, jamba_peak)
    log(f"mesh: l4 + l5 {time.perf_counter() - t0:.1f} s")
    log(f"mesh: part {time.perf_counter() - t_part:.1f} s")
    return {"attn_fused_staged": k6, "step": l1}


# (n) the four examples on the port (examples/torch_*.py), each on the
# card at a small step count: the quickstart (K3 through its pallas_ell
# product), the GCN (its aggregation on the card's default lowering, K4),
# serving (three reduced archs) and training (reduced mixtral on a (2, 2)
# mesh of the card's chips)
EXAMPLE_RUNS = (("quickstart", []), ("gnn_graphconv", []),
                ("serve_lm", ["--gen", "8"]),
                ("train_lm", ["--steps", "10", "--batch", "8", "--seq", "64",
                              "--dp", "2", "--tp", "2"]))


def phase_examples() -> dict:
    """(n) each example's ``main`` on the card, its seconds by the host
    clock (its last result read back), the claims it asserts itself
    (GCN accuracy > 0.9, the loss falling) held, and the K3/K4 launches
    the examples make (zeroed just before, read just after)."""
    import importlib.util
    from repro_torch import kernels

    counted = {name: getattr(kernels, name)
               for name in ("spmm_ell_fused_staged", "spmm_bcsr_fused_staged")}
    for k in counted.values():
        k.launches = 0
    root = Path(__file__).resolve().parent / "examples"
    secs = {}
    for name, argv in EXAMPLE_RUNS:
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", root / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if name == "gnn_graphconv":
            assert out["accuracy"] > 0.9 and out["backend"] == \
                "pallas_bcsr" and out["staging"] == "dma", out
            gcn = f"{out['accuracy']:.3f} through {out['backend']}/" \
                f"{out['staging']}"
        if name == "train_lm":
            assert out[-1] < out[0], out
            losses = out
    launches = {name: k.launches for name, k in counted.items()}
    log(f"examples: " + ", ".join(f"torch_{k} {v:.1f} s"
                                  for k, v in secs.items())
        + f" on the card (GCN accuracy {gcn}; train_lm loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {len(losses)} steps on (2, 2)); launches: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; card {card_line()}")
    assert all(v > 0 for v in launches.values()), launches
    return launches


# -- K2 and K6 beside a parent tree's (``--ab-parent``, ``--ab-ptxas``) -----

def parent_package(root: Path):
    """The ``repro_torch`` package of the tree at ``root`` (a commit
    unpacked with ``git archive``), imported as ``ab_parent`` beside this
    tree's: its wrappers build their own kernels into ``root/build``."""
    import importlib.util
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "ab_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["ab_parent"] = module
    spec.loader.exec_module(module)
    return module


# the kernels --ab-ptxas holds to the parent's registers and spills; K1
# and K10 (redesigned) are printed beside the parent's
PTXAS_KEPT = ("spmm_bcsr_fused", "spmm_ell_fused_staged",
              "spmm_bcsr_fused_staged", "attn_fused", "attn_fused_staged",
              "sddmm", "spmm_ell_segment")


def ab_ptxas(parent) -> bool:
    """ptxas's registers and spills of K1-K7, K9 and K10, this tree
    beside the parent's; True when those of :data:`PTXAS_KEPT` are the
    parent's."""
    from repro_torch.kernels import _build
    names = SPMM_KERNELS + ATTN_KERNELS + ORACLE_KERNELS
    same = True
    for build in (_build, parent.kernels._build):
        build.build(names)
        missing = [n for n in names if n not in build.BUILD_LOG]
        if missing:
            raise SystemExit(f"chip_smoke: {missing} were built before "
                             f"under {build.BUILD_DIR}; remove it")
    for name in names:
        mine = ptxas_lines(_build.BUILD_LOG[name])
        theirs = ptxas_lines(parent.kernels._build.BUILD_LOG[name])
        if name in PTXAS_KEPT:
            same &= mine == theirs
        log(f"ptxas {name}: equal to the parent's: {mine == theirs}; "
            + "; ".join(f"{inst}: {regs} registers, {spill}"
                        for inst, _, regs, spill in mine))
        if mine != theirs:
            log(f"ptxas {name} (parent): " + "; ".join(
                f"{inst}: {regs} registers, {spill}"
                for inst, _, regs, spill in theirs))
    return same


def ab_turns(a, b):
    """Medians of a and b in turns a b b a."""
    t = [time_ms(f) for f in (a, b, b, a)]
    return (t[0], t[3]), (t[1], t[2])


def ab_attention(parent) -> None:
    """K5 and K6 beside the parent's on the longformer mask at S = 32768
    (both fused backends at bm = bk = 8, and pallas_bcsr at bm = 16 and
    at bk = 1) and at the layer's S = 4096, every output bit for bit the
    parent's K5; then K5 alone on a small mask at a ragged head width,
    at one where the ring takes a single stage and at one where it takes
    none (LEAN), and with a misaligned K."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import JitCache, compile_sparse_attention
    from repro_torch.core.plan import MXU_TAG
    from repro_torch.models.sparse_attention import sparse_attention_mask
    geo = _kernel_module("attn_fused").resident_geometry
    cfg = get_config("longformer-1.4b")
    cases = [(ATTN_SEQ, "pallas_bcsr", 8, 8), (ATTN_SEQ, "pallas_ell", 8, 8),
             (ATTN_SEQ, "pallas_bcsr", 16, 8), (ATTN_SEQ, "pallas_bcsr", 8, 1),
             (SATTN_SEQ, "pallas_bcsr", 8, 8), (SATTN_SEQ, "pallas_ell", 8, 8)]
    for seq, backend, bm, bk in cases:
        a = sparse_attention_mask(seq, cfg.sparse_attn_window,
                                  cfg.sparse_attn_global)
        gen = torch.Generator(device="cuda").manual_seed(6)
        q, k, v = (torch.randn(n, cfg.head_dim, device="cuda", generator=gen)
                   for n in (a.m, a.n, a.n))
        c = compile_sparse_attention(a, cfg.head_dim, cfg.head_dim,
                                     backend=backend, bm=bm, bk=bk,
                                     cache=JitCache())
        ops, knobs = c.fused_operands(a.vals, q, k, v)
        ws = c.workspace
        win = dict(span=ws.max_span, cspan=ws.max_cspan)

        def k6_theirs():
            return parent.kernels.attn_fused_staged(*ops, **knobs, **win)

        def k6_mine():
            return kernels.attn_fused_staged(*ops, **knobs, **win)

        def k5_theirs():
            return parent.kernels.attn_fused(*ops, **knobs)

        def k5_mine():
            return kernels.attn_fused(*ops, **knobs)
        want = k5_theirs()
        same5 = torch.equal(k5_mine(), want)
        same6 = torch.equal(k6_theirs(), want) and torch.equal(k6_mine(),
                                                               want)
        t6_theirs, t6_mine = ab_turns(k6_theirs, k6_mine)
        t5_theirs, t5_mine = ab_turns(k5_theirs, k5_mine)
        mxu = int((ws.blk_tag == MXU_TAG).sum())
        log(f"K5 S={seq} {backend} bm={bm} bk={bk} ({mxu} MXU of "
            f"{ws.num_blocks} descriptors, "
            f"{geo(bm=bm, bk=bk, dh_pad=cfg.head_dim)['stages']} stages): "
            f"parent {t5_theirs[0]:.4f}, {t5_theirs[1]:.4f}; this tree "
            f"{t5_mine[0]:.4f}, {t5_mine[1]:.4f} ms; bit-identical to the "
            f"parent's K5: {same5}")
        log(f"K6 S={seq} {backend} bm={bm} bk={bk}: parent "
            f"{t6_theirs[0]:.4f}, {t6_theirs[1]:.4f}; this tree "
            f"{t6_mine[0]:.4f}, {t6_mine[1]:.4f} ms; both bit-identical to "
            f"the parent's K5: {same6}")
        if not (same5 and same6):
            raise SystemExit("chip_smoke: K5 or K6 differs from the "
                             "parent's K5")
        del c, ops
    # K5 alone at the head widths K6 does not take, on a small mask: the
    # operands are the artifact's cut to the width (direct calls)
    from repro_torch.core import CSRMatrix
    a = CSRMatrix.from_dense(over_cap_dense())
    for backend, bm, bk, dh, misalign in (
            ("pallas_bcsr", 8, 8, 100, False), ("pallas_ell", 2, 8, 100,
                                                 False),
            ("pallas_bcsr", 16, 32, 1024, False),
            ("pallas_bcsr", 8, 8, 4096, False),
            ("pallas_ell", 8, 8, 4096, False),
            ("pallas_bcsr", 8, 8, 128, True)):
        gen = torch.Generator(device="cuda").manual_seed(dh)
        q = torch.randn(a.m, dh, device="cuda", generator=gen) / dh ** 0.5
        k = torch.randn(a.n, dh, device="cuda", generator=gen)
        v = torch.randn(a.n, 128, device="cuda", generator=gen)
        c = compile_sparse_attention(a, dh, 128, backend=backend, bm=bm,
                                     bk=bk, merge_threshold=16,
                                     cache=JitCache())
        ops, knobs = c.fused_operands(a.vals, q, k, v)
        ops = list(ops)
        ops[6] = ops[6][:, :dh].contiguous()
        ops[7] = ops[7][:, :dh].contiguous()
        if misalign:
            ops[7] = misaligned(ops[7])

        def theirs():
            return parent.kernels.attn_fused(*ops, **knobs)

        def mine():
            return kernels.attn_fused(*ops, **knobs)
        same = torch.equal(mine(), theirs())
        t_theirs, t_mine = ab_turns(theirs, mine)
        g = geo(bm=bm, bk=bk, dh_pad=-(-dh // 32) * 32)
        log(f"K5 small mask {backend} bm={bm} bk={bk} dh={dh}"
            f"{' (K misaligned)' if misalign else ''} "
            f"(mw={c.workspace.merge_width}, {g['stages']} stages"
            f"{', LEAN' if g['stages'] == 0 else ''}): parent "
            f"{t_theirs[0]:.4f}, {t_theirs[1]:.4f}; this tree "
            f"{t_mine[0]:.4f}, {t_mine[1]:.4f} ms; bit-identical to the "
            f"parent's K5: {same}")
        if not same:
            raise SystemExit("chip_smoke: K5 differs from the parent's")


def ab_spmm(parent, instances: dict) -> None:
    """K2 beside the parent's on the two 2^20-row instances, bit for bit
    each other and K4; then K1 beside the parent's under pallas_ell /
    resident, bit for bit each other and K3: on both instances at bm =
    8, and on the uniform graph at bm = 1 and 16, with merged trips (mw
    > 1), called directly at the unplanned width 47 and with a
    misaligned X."""
    from repro_torch import kernels
    from repro_torch.core import JitCache, compile_spmm
    for label, (a, x) in instances.items():
        c = compile_spmm(a, D_MAIN, backend="pallas_bcsr",
                         staging="resident", cache=JitCache())
        ops, knobs = c.fused_operands(a.vals, x)
        c4 = compile_spmm(a, D_MAIN, backend="pallas_bcsr", cache=JitCache())
        ops4, knobs4 = c4.fused_operands(a.vals, x)
        knobs4.update(span=c4.workspace.max_span, cspan=c4.workspace.max_cspan)

        def theirs():
            return parent.kernels.spmm_bcsr_fused(*ops, **knobs)

        def mine():
            return kernels.spmm_bcsr_fused(*ops, **knobs)

        def k4():
            return kernels.spmm_bcsr_fused_staged(*ops4, **knobs4)
        same = torch.equal(theirs(), mine()) and torch.equal(mine(), k4())
        t_theirs, t_mine = ab_turns(theirs, mine)
        log(f"K2 {label}: parent {t_theirs[0]:.4f}, {t_theirs[1]:.4f}; this "
            f"tree {t_mine[0]:.4f}, {t_mine[1]:.4f}; K4 {time_ms(k4):.4f} "
            f"ms; bit-identical (parent, this tree, K4): {same}")
        if not same:
            raise SystemExit("chip_smoke: K2 differs from the parent's or K4")
        del c, c4, ops, ops4
    cases = [("uniform", 8, 0, None), ("banded", 8, 0, None),
             ("uniform", 1, 0, None), ("uniform", 16, 0, None),
             ("uniform", 8, 64, None), ("uniform", 8, 0, 47),
             ("uniform", 8, 0, 200), ("uniform", 8, 0, "misaligned")]
    k1 = _kernel_module("spmm_ell_fused")
    for label, bm, mt, how in cases:
        a, x = instances[label]
        c = compile_spmm(a, D_MAIN, backend="pallas_ell", staging="resident",
                         bm=bm, merge_threshold=mt, cache=JitCache())
        ops, knobs = c.fused_operands(a.vals, x)
        c3 = compile_spmm(a, D_MAIN, backend="pallas_ell", bm=bm,
                          merge_threshold=mt, cache=JitCache())
        ops3, knobs3 = c3.fused_operands(a.vals, x)
        knobs3.update(span=c3.workspace.max_span,
                      cspan=c3.workspace.max_cspan)
        ops = list(ops)
        # K3 takes whole tiles on a 16-byte boundary: the planned X
        x3 = ops3[4]
        if how == 47:           # the width as given, not planned
            ops[4] = ops[4][:, :47].contiguous()
            x3 = torch.nn.functional.pad(ops[4], (0, D_MAIN - 47))
        elif how == 200:        # a partial last column tile
            gen = torch.Generator(device="cuda").manual_seed(200)
            ops[4] = torch.randn(ops[4].shape[0], 200, device="cuda",
                                 generator=gen)
            x3 = torch.nn.functional.pad(ops[4], (0, 56))
        elif how == "misaligned":
            ops[4] = misaligned(ops[4])
        width = ops[4].shape[1]

        def theirs():
            return parent.kernels.spmm_ell_fused(*ops, **knobs)

        def mine():
            return kernels.spmm_ell_fused(*ops, **knobs)

        def k3():
            y = kernels.spmm_ell_fused_staged(*ops3[:4], x3, **knobs3)
            return y if width == x3.shape[1] else y[:, :width]
        want = theirs()
        same = torch.equal(mine(), want) and torch.equal(k3(), want)
        t_theirs, t_mine = ab_turns(theirs, mine)
        note = " (X misaligned)" if how == "misaligned" else ""
        note += (", ring" if k1.ring_route(width) else
                 f", narrow, {k1.narrow_threads(width)} threads")
        log(f"K1 {label} bm={bm} mw={c.workspace.merge_width} "
            f"d_pad={width}{note}: parent {t_theirs[0]:.4f}, "
            f"{t_theirs[1]:.4f}; this tree {t_mine[0]:.4f}, "
            f"{t_mine[1]:.4f}; K3 {time_ms(k3):.4f} ms; bit-identical "
            f"(parent, this tree, K3): {same}")
        if not same:
            raise SystemExit("chip_smoke: K1 differs from the parent's or K3")
        del c, c3, ops, ops3, x3


def ab_bcsr(parent, a, x) -> None:
    """K10 beside the parent's on ``BCSRMatrix.from_csr`` of the banded
    stencil, in turns A B B A, each output bit for bit the parent's and
    the plain version's: at bm = bk = 8 (kmax 5), a direct call at the
    unplanned width 47 (the one-CTA-a-block-row body), with a misaligned
    X, at bm = 16 and at bk = 1."""
    from repro_torch import kernels
    from repro_torch.core import BCSRMatrix
    k10 = _kernel_module("spmm_bcsr")
    blocks = {}
    for bm, bk, how in ((8, 8, None), (8, 8, 47), (8, 8, "misaligned"),
                        (16, 8, None), (8, 1, None)):
        if (bm, bk) not in blocks:
            blocks.clear()
            t0 = time.perf_counter()
            b = BCSRMatrix.from_csr(a, bm, bk)
            blocks[(bm, bk)] = (b, *k10._pad_to_kmax(b),
                                time.perf_counter() - t0)
        b, cols, vals, kmax, seconds = blocks[(bm, bk)]
        xp = torch.nn.functional.pad(x, (0, 0, 0, b.shape[1] - x.shape[0]))
        if how == 47:           # the width as given, not planned
            xp = xp[:, :47].contiguous()
        elif how == "misaligned":
            xp = misaligned(xp)

        def theirs():
            return parent.kernels.spmm_bcsr(cols, vals, xp, kmax=kmax)

        def mine():
            return kernels.spmm_bcsr(cols, vals, xp, kmax=kmax)
        want = theirs()
        same = (torch.equal(mine(), want)
                and torch.equal(kernels.spmm_bcsr_plain(cols, vals, xp,
                                                        kmax=kmax), want))
        t_theirs, t_mine = ab_turns(theirs, mine)
        width = xp.shape[1]
        route = ("ring" if k10.ring_route(width, bm=bm, bk=bk) else
                 f"narrow, {k10.narrow_threads(width)} threads")
        note = " (X misaligned)" if how == "misaligned" else ""
        log(f"K10 banded bm={bm} bk={bk} kmax={kmax} d_pad={width}{note}, "
            f"{route} ({b.n_block_rows} block-rows; from_csr + padding "
            f"{seconds:.1f} s): parent {t_theirs[0]:.4f}, {t_theirs[1]:.4f}; "
            f"this tree {t_mine[0]:.4f}, {t_mine[1]:.4f} ms; bit-identical "
            f"(parent, plain): {same}")
        if not same:
            raise SystemExit("chip_smoke: K10 differs from the parent's or "
                             "its plain version")
        del xp
    del blocks


def ab_sddmm(parent, a, x) -> None:
    """K7 beside the parent's on the uniform graph's 16.8 M pairs at
    d_pad 47 (a direct call at an unplanned width: one 47-wide tile),
    128, 256 and 1024 (two 512-wide tiles), bit for bit the parent's, and
    torch.sparse.sampled_addmm at each width."""
    from repro_torch import kernels
    k7 = _kernel_module("sddmm")
    a_sp = _sparse_csr(a)
    for d in (47, D_MAIN, 256, 1024):
        gen = torch.Generator(device="cuda").manual_seed(d)
        g = torch.randn(a.m, d, device="cuda", generator=gen)
        xd = x if d == D_MAIN else torch.randn(a.n, d, device="cuda",
                                                generator=gen)
        ops7 = k7._csr_pairs(a, g, xd, device=str(xd.device))
        if d == 47:                 # the width as given, not planned
            ops7 = ops7[:2] + (g, xd)
        d_pad = ops7[3].shape[1]

        def theirs():
            return parent.kernels.sddmm(*ops7)

        def mine():
            return kernels.sddmm(*ops7)
        same = torch.equal(theirs(), mine())
        t_theirs, t_mine = ab_turns(theirs, mine)
        xt = xd.t()
        lib = time_ms(lambda: torch.sparse.sampled_addmm(a_sp, g, xt,
                                                         beta=0.0))
        log(f"K7 uniform d_pad={d_pad} (lane tile "
            f"{k7._lane_tile(d_pad)}): parent {t_theirs[0]:.4f}, "
            f"{t_theirs[1]:.4f}; this tree {t_mine[0]:.4f}, "
            f"{t_mine[1]:.4f}; torch.sparse.sampled_addmm {lib:.4f} ms; "
            f"bit-identical to the parent's: {same}")
        if not same:
            raise SystemExit("chip_smoke: K7 differs from the parent's")
        del ops7, g, xd


def segment_pieces(c, a, x):
    """K9's operands for each segment of the resident ``pallas_ell``
    artifact ``c``'s plan (X padded to the plan's width), and a function
    that scatters the segments' outputs back into K1's row order."""
    vals_ext = torch.cat([a.vals.float(), a.vals.new_zeros(1)])
    x_pad = torch.nn.functional.pad(x, (0, c.d_tiling.d_pad - x.shape[1]))
    segs = [(torch.from_numpy(s.cols_pad.reshape(-1)).cuda(),
             vals_ext[torch.from_numpy(s.gather_idx).cuda()], x_pad, s)
            for s in c.plan.segments]

    def scatter(outs):
        y = torch.zeros((a.m, x.shape[1]), device="cuda")
        for out, (_, _, _, s) in zip(outs, segs):
            y[torch.from_numpy(s.row_ids).cuda()] = out[:s.R, :x.shape[1]]
        return y
    return segs, scatter


def ab_segment(parent, a, x) -> None:
    """K9 beside the parent's: on small fixtures at every supported bm
    (each segment bit for bit the parent's, the segments scattered back
    bit for bit K1's forward), then over the uniform graph's nnz_split
    segments at bm = 8, timed A B B A as a sum over the segments, beside
    K1 on the whole plan and torch.sparse.mm."""
    from repro_torch import kernels
    from repro_torch.core import CSRMatrix, JitCache, compile_spmm, random_csr
    from repro_torch.core.plan import STRATEGIES
    from repro_torch.kernels.spmm_ell_fused import SUPPORTED_BM
    fixtures = {
        "mixed": CSRMatrix.from_dense(mixed_dense(0)),
        "empty_rows": random_csr(300, 256, density=0.03, family="powerlaw",
                                 seed=1),
        "hub": CSRMatrix.from_dense(hub_dense(600, 40)),
    }
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = 0
    for (fname, fa), strategy, bm in itertools.product(
            fixtures.items(), STRATEGIES, SUPPORTED_BM):
        c = compile_spmm(fa, 20, backend="pallas_ell", staging="resident",
                         strategy=strategy, bm=bm, cache=JitCache())
        xf = torch.randn(fa.n, 20, device="cuda", generator=gen)
        segs, scatter = segment_pieces(c, fa, xf)
        outs = []
        for cols, vals, xp, _ in segs:
            mine = kernels.spmm_ell_segment(cols, vals, xp, bm=bm)
            theirs = parent.kernels.spmm_ell_segment(cols, vals, xp, bm=bm)
            if not torch.equal(mine, theirs):
                raise SystemExit(f"chip_smoke: K9 differs from the parent's "
                                 f"({fname}, {strategy}, bm = {bm})")
            outs.append(mine)
        if not torch.equal(scatter(outs), c(fa.vals, xf)):
            raise SystemExit(f"chip_smoke: K9 differs from K1 ({fname}, "
                             f"{strategy}, bm = {bm})")
        cases += 1
    log(f"K9 fixtures: {cases} (fixture, strategy, bm in {SUPPORTED_BM}) "
        f"cases, every segment bit-identical to the parent's and the "
        f"segments to K1's forward")
    c = compile_spmm(a, D_MAIN, backend="pallas_ell", staging="resident",
                     cache=JitCache())
    segs, scatter = segment_pieces(c, a, x)

    def theirs():
        return [parent.kernels.spmm_ell_segment(cols, vals, xp, bm=c.bm)
                for cols, vals, xp, _ in segs]

    def mine():
        return [kernels.spmm_ell_segment(cols, vals, xp, bm=c.bm)
                for cols, vals, xp, _ in segs]
    same = all(torch.equal(u, v) for u, v in zip(theirs(), mine()))
    same_k1 = torch.equal(scatter(mine()), c(a.vals, x))
    t_theirs, t_mine = ab_turns(theirs, mine)
    operands1, knobs1 = c.fused_operands(a.vals, x)
    k1 = time_ms(lambda: kernels.spmm_ell_fused(*operands1, **knobs1))
    a_sp = _sparse_csr(a)
    lib = time_ms(lambda: torch.sparse.mm(a_sp, x))
    log(f"K9 uniform, {len(segs)} segments at bm = {c.bm}, summed: parent "
        f"{t_theirs[0]:.4f}, {t_theirs[1]:.4f}; this tree {t_mine[0]:.4f}, "
        f"{t_mine[1]:.4f}; K1 {k1:.4f}; torch.sparse.mm {lib:.4f} ms; "
        f"bit-identical to the parent's: {same}, to K1: {same_k1}")
    if not (same and same_k1):
        raise SystemExit("chip_smoke: K9 differs from the parent's or K1")


# -- --cards 4: the mesh over cards ----------------------------------------
#
# (o1) K8 over chip_mesh(4), one card a chip: the small fixtures, then
# compile_spmm(a, 128, mesh=) on both 2^20-row instances with the default
# x_sharding ("rows" on a mesh over cards: the exact-panel exchange
# crosses NVLink) and "replicated", and compile_sparse_attention on the
# longformer mask; (o2) the (l1) step on make_host_mesh(2, 2, cards=4)
# and on the one-card (2, 2) mesh in the same call; (o3) run_training at
# --dp 2 --tp 2 --cards 4 stopped and resumed on plan_remesh(2,
# model_parallel=1) over cuda:0..1, against the same runs on one card;
# (o4) compressed_psum over 4 cards against one card's chips; (o6) the
# (l1) step on make_host_mesh(1, 4, cards=4) against one card's (1, 4)

NVLINK_BYTES_PER_S = 450e9    # H100 SXM NVLink, each way (a card's links)


class _Wire:
    """While active, adds up the bytes every ``Tensor.to`` copies from
    one CUDA card to another: ``moved[(src, dst)]``, and ``graded``, the
    plain ``.to`` copies whose source carries a gradient (autograd's own
    backward sends each such gradient back over the same wire, not
    counted; ``sharding.card_copy`` copies in both directions through
    ``Tensor.to``, so both count)."""

    def __enter__(self):
        self.moved = collections.Counter()
        self.graded = 0
        self.orig = orig = torch.Tensor.to

        def to(t, *args, **kw):
            out = orig(t, *args, **kw)
            if out.device != t.device and t.is_cuda and out.is_cuda:
                n = out.numel() * out.element_size()
                self.moved[(t.device.index, out.device.index)] += n
                if t.requires_grad and torch.is_grad_enabled():
                    self.graded += n
            return out
        torch.Tensor.to = to
        return self

    def __exit__(self, *exc):
        torch.Tensor.to = self.orig
        return False

    def total(self) -> int:
        return sum(self.moved.values())

    def link(self, card: int) -> int:
        """The larger of the bytes ``card`` sent and received."""
        out = sum(n for (s_, _), n in self.moved.items() if s_ == card)
        into = sum(n for (_, d), n in self.moved.items() if d == card)
        return max(out, into)


class _CardLaunches(_Patched):
    """Counts, by card, the launches of the named kernel functions while
    active (the card of the last tensor argument, where a wrapper
    launches); each function's own ``launches`` counter passes through."""

    def __enter__(self):
        self.by_card = collections.Counter()
        return super().__enter__()

    def wrap(self, target, orig):
        tally = self.by_card

        class Counted:
            def __call__(self, *args, **kw):
                card = next(t.device.index for t in reversed(args)
                            if isinstance(t, torch.Tensor))
                tally[card] += 1
                return orig(*args, **kw)

            @property
            def launches(self):
                return orig.launches

            @launches.setter
            def launches(self, n):
                orig.launches = n
        return Counted()

    def cards(self, n: int) -> list:
        return [self.by_card[i] for i in range(n)]


def wall_ms(fn, devices, reps: int = 10) -> float:
    """Median host milliseconds of ``fn()`` over ``reps`` runs, every
    card of ``devices`` synchronised before and after each (after two
    warm-up runs): a call whose work spans cards."""
    from repro_torch.distributed.sharding import synchronize
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        synchronize(devices)
        t0 = time.perf_counter()
        fn()
        synchronize(devices)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def card_peaks(fn, devices) -> list:
    """Each card's peak GiB over what it held when ``fn()`` started."""
    from repro_torch.distributed.sharding import synchronize
    synchronize(devices)
    base = []
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
        base.append(torch.cuda.memory_allocated(d))
    fn()
    synchronize(devices)
    return [(torch.cuda.max_memory_allocated(d) - b) / 2 ** 30
            for d, b in zip(devices, base)]


def chip_kernel_ms(kernel, operands, mesh, knobs: list) -> list:
    """Each chip's kernel alone, on its card, by CUDA events there."""
    out = []
    for chip, dev in enumerate(mesh.devices):
        args = [t[chip] if isinstance(t, (tuple, list)) else t
                for t in operands]
        with torch.cuda.device(dev):
            out.append(time_ms(lambda: kernel(*args, **knobs[chip])))
    return out


def cards_bound(chip_bounds: list, wire: "_Wire") -> tuple:
    """The least time for work split over the cards: each card's bound
    (its chip's bytes or operations, or the bytes its links carry over
    NVLINK_BYTES_PER_S, the larger), the slowest card's."""
    per = []
    for card, (t, kind) in enumerate(chip_bounds):
        t_link = wire.link(card) / NVLINK_BYTES_PER_S * 1e3
        per.append((t, kind) if t >= t_link else (t_link, "bytes"))
    return max(per)


def cards_spmm(instances: dict, n: int) -> dict:
    """(o1) compile_spmm over ``chip_mesh(n)`` at size: one launch a
    card a forward, every output and the default's dvals and dX bit for
    bit the unsharded forward's; times beside the one-card n-chip mesh's
    and the JSON rows of K8's SpMM wrappers."""
    from repro_torch import kernels
    from repro_torch.core import JitCache, chip_mesh, compile_spmm
    from repro_torch.distributed import sharded_x
    from repro_torch.kernels import ops

    mesh, one = chip_mesh(n), shard_mesh(n)
    devices = list(mesh.devices)
    cache = JitCache()
    runs = {"a": ("uniform", "auto", None),
            "a/replicated": ("uniform", "auto", "replicated"),
            "a/pallas_ell": ("uniform", "pallas_ell", None),
            "b": ("banded", "auto", None)}
    arts, flat, local = {}, {}, {}
    for label, (inst, backend, xs) in runs.items():
        a, _ = instances[inst]
        t0 = time.perf_counter()
        c = compile_spmm(a, D_MAIN, backend=backend, x_sharding=xs,
                         mesh=mesh, cache=cache)
        assert c.staging == "dma" and c.x_sharding == (xs or "rows"), label
        arts[label] = c
        flat[label] = compile_spmm(a, D_MAIN, backend=backend, cache=cache)
        local[label] = compile_spmm(a, D_MAIN, backend=backend,
                                    x_sharding=c.x_sharding, mesh=one,
                                    cache=cache)
        log(f"cards/o1 {label}: compile_spmm over {n} cards "
            f"{time.perf_counter() - t0:.2f} s (with its unsharded and "
            f"one-card twins): {c.backend}/{c.staging}/{c.x_sharding}, "
            f"rows per card "
            f"{np.diff(c.sharded_workspace.bounds).tolist()}")
        # the per-chip tables lie on their cards from compile time on
        sw = c._sharded
        for chip, dev in enumerate(mesh.devices):
            assert all(t[chip].device == dev for t in (
                sw.blk_tag, sw.blk_off, sw.blk_coff, sw.blk_L,
                sw.cols_flat, sw.gather_flat)), label

    # the path, counted: zeroed just before, read just after
    for name in SPMM_KERNELS + SHARDED_KERNELS:
        getattr(kernels, name).launches = 0
    outputs = {}
    targets = [(f"repro_torch.kernels.{m}", f) for m, f in (
        ("spmm_ell_fused", "spmm_ell_fused_staged"),
        ("spmm_bcsr_fused", "spmm_bcsr_fused_staged"))]
    for label, c in arts.items():
        a, x = instances[runs[label][0]]
        ops.reset_dispatch_counts()
        with _CardLaunches(*targets) as by_card:
            outputs[label] = c(a.vals, x)
        assert dict(ops.DISPATCH_COUNTS) == sharded_dispatches(c), \
            (label, dict(ops.DISPATCH_COUNTS))
        assert by_card.cards(n) == [1] * n, (label, by_card.by_card)
    torch.cuda.synchronize()
    launches = {name: getattr(kernels, name).launches
                for name in SPMM_KERNELS + SHARDED_KERNELS}
    log(f"cards/o1 path launches: {launches}; one a card a forward")
    for label, y in outputs.items():
        a, x = instances[runs[label][0]]
        assert y.device == mesh.devices[0] and bool(torch.isfinite(y).all())
        assert torch.equal(y, flat[label](a.vals, x)), label
    log(f"cards/o1: every forward over {n} cards bit-identical to the "
        f"unsharded forward ({', '.join(outputs)})")
    del outputs

    # dvals and dX through the default (rows) artifact on (a)
    a, x = instances["uniform"]
    g = torch.randn(a.m, D_MAIN, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    grads = []
    for c in (arts["a"], flat["a"]):
        vals = a.vals.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        (c(vals, xx) * g).sum().backward()
        grads.append((vals.grad, xx.grad))
        del vals, xx
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    t = arts["a"]._transpose
    log(f"cards/o1 a: dvals and dX of (A·X * G).sum() over {n} cards "
        f"bit-identical to the unsharded artifact's (transposed artifact "
        f"{t.backend}/{t.staging}/{t.x_sharding} over {t.mesh.size} cards)")
    del grads, g
    torch.cuda.empty_cache()

    rows = {}
    for label, c in arts.items():
        a, x = instances[runs[label][0]]
        name = ("spmm_ell_fused_sharded" if c.backend == "pallas_ell"
                else "spmm_bcsr_fused_sharded")
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        _, kernel, _ = kernel_pair(c.backend, c.staging)
        operands, knobs = c.sharded_operands(a.vals, x)
        kw = dict(knobs, **sharded_knobs(c, c.staging))
        sw = c._sharded
        got = wrapper(*operands, **kw)
        want = plain(*operands, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        del got, want

        def exchange():
            return sharded_x(operands[-1], mesh, sw.x_sharding, sw.x_send,
                             sw.x_recv)
        chip_x = exchange()
        _, _, chip_bounds, xbytes = sharded_bound(c, operands, chip_x)
        per = dict(bm=c.bm, mw=sw.merge_width)
        if c.backend == "pallas_bcsr":
            per["bk"] = c.bk
        chip_ms = chip_kernel_ms(
            kernel, list(operands[:-1]) + [chip_x], mesh,
            [dict(per, span=sw.chip_span[i], cspan=sw.chip_cspan[i])
             for i in range(n)])
        with _Wire() as wire:
            exchange()
        x_wire = wire.total()
        del chip_x
        with _Wire() as wire:
            wrapper(*operands, **kw)
        with _Wire() as fwd_wire:
            c(a.vals, x)
        bound_ms, bound_by = cards_bound(chip_bounds, wire)
        exchange_ms = wall_ms(exchange, devices) \
            if sw.x_sharding == "rows" else 0.0
        ms = wall_ms(lambda: wrapper(*operands, **kw), devices)
        fwd_ms = wall_ms(lambda: c(a.vals, x), devices)
        one_ms = wall_ms(lambda: local[label](a.vals, x), devices)
        flat_ms = wall_ms(lambda: flat[label](a.vals, x), devices)
        plain_ms = wall_ms(lambda: plain(*operands, **kw), devices, reps=3)
        peaks = card_peaks(lambda: c(a.vals, x), devices)
        one_peak = card_peaks(lambda: local[label](a.vals, x), devices)[0]
        a_sparse = _sparse_csr(a)
        library_ms = time_ms(lambda: torch.sparse.mm(a_sparse, x))
        del a_sparse
        log(f"cards/o1 {label} ({c.backend}/{c.staging}/{sw.x_sharding}): "
            f"{name} {ms:.4f} ms over {n} cards (host clock, every card "
            f"synchronised; the kernel on each card "
            f"{', '.join(f'{t:.4f}' for t in chip_ms)} ms by its CUDA "
            f"events); exchange {exchange_ms:.4f} ms moving "
            f"{x_wire / 1e6:.1f} MB between cards ({xbytes / 2 ** 20:.1f} "
            f"MiB of touched panels); the wrapper's copies between cards "
            f"{wire.total() / 1e6:.1f} MB, the forward's "
            f"{fwd_wire.total() / 1e6:.1f} MB "
            f"({ {f'{s_}->{d}': round(v / 1e6, 1) for (s_, d), v in sorted(fwd_wire.moved.items())} }"
            f" MB); forward over {n} cards {fwd_ms:.4f} ms against "
            f"{n} chips of one card {one_ms:.4f} ms and the unsharded "
            f"forward {flat_ms:.4f} ms (same clock); plain {plain_ms:.4f} "
            f"ms; torch.sparse.mm {library_ms:.4f} ms (CUDA events, one "
            f"card); bound {bound_ms:.4f} ms ({bound_by}; cards "
            f"{', '.join(f'{t:.4f}' for t, _ in chip_bounds)} ms of HBM, "
            f"links at {NVLINK_BYTES_PER_S / 1e9:.0f} GB/s each way); peak "
            f"memory over the resident inputs by card "
            f"{[round(p, 3) for p in peaks]} GiB, {n} chips of one card "
            f"{one_peak:.3f} GiB; max |kernel - plain| {err:.3g}")
        if label in ("a", "a/pallas_ell"):
            rows[name] = dict(name=name, route="cuda", **KERNELS[name],
                              launches=launches[name], max_abs_err=err,
                              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=library_ms)
    return rows


def cards_attention(n: int) -> dict:
    """(o1) compile_sparse_attention on the longformer-1.4b mask (S =
    ATTN_SEQ, one head) over ``chip_mesh(n)``: one K6 launch a card, bit
    for bit the unsharded default forward; its JSON row."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import (JitCache, chip_mesh,
                                  compile_sparse_attention)
    from repro_torch.kernels import ops
    from repro_torch.models.sparse_attention import sparse_attention_mask

    cfg = get_config("longformer-1.4b")
    dh = dv = cfg.head_dim
    a = sparse_attention_mask(ATTN_SEQ, cfg.sparse_attn_window,
                              cfg.sparse_attn_global)
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(a.m, dh, device="cuda", generator=gen)
    k = torch.randn(a.n, dh, device="cuda", generator=gen)
    v = torch.randn(a.n, dv, device="cuda", generator=gen)
    mesh = chip_mesh(n)
    devices = list(mesh.devices)
    cache = JitCache()
    t0 = time.perf_counter()
    c = compile_sparse_attention(a, dh, dv, mesh=mesh, cache=cache)
    c0 = compile_sparse_attention(a, dh, dv, cache=cache)
    c1 = compile_sparse_attention(a, dh, dv, mesh=shard_mesh(n),
                                  cache=cache)
    sw = c.sharded_workspace
    log(f"cards/o1 attention: compile_sparse_attention over {n} cards "
        f"{time.perf_counter() - t0:.2f} s (with its unsharded and "
        f"one-card twins): {c.backend}/{c.staging}, rows per card "
        f"{np.diff(sw.bounds).tolist()}")
    assert c.backend == "pallas_bcsr" and c.staging == "dma"
    k6, k8 = kernels.attn_fused_staged, kernels.attn_fused_sharded
    k6.launches = k8.launches = 0
    ops.reset_dispatch_counts()
    with _CardLaunches(("repro_torch.kernels.attn_fused",
                        "attn_fused_staged")) as by_card:
        y = c(a.vals, q, k, v)
    torch.cuda.synchronize()
    launches = k8.launches
    want = {"attn_fused": n, "attn_fused_sharded": 1, "attn_fused_dma": n}
    if sw.merge_width > 1:
        want["attn_fused_merged"] = n
    assert dict(ops.DISPATCH_COUNTS) == want, dict(ops.DISPATCH_COUNTS)
    assert (k6.launches, k8.launches) == (n, n)
    assert by_card.cards(n) == [1] * n, by_card.by_card
    assert torch.equal(y, c0(a.vals, q, k, v))
    log(f"cards/o1 attention: {n} attn_fused_staged launches, one a card, "
        f"output bit-identical to the unsharded default forward")
    del y
    operands, knobs = c.sharded_operands(a.vals, q, k, v)
    kw = dict(knobs, **sharded_knobs(c, "dma"))
    got = k8(*operands, **kw)
    want_y = kernels.attn_fused_sharded_plain(*operands, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want_y, rtol=1e-5, atol=1e-5)
    err = (got - want_y).abs().max().item()
    del got, want_y
    chip_bounds = attn_chip_bounds(a, sw, dh, dv)
    # each card's K and V: replicated by the wrapper
    kv = [operands[7].to(dev) for dev in devices]
    vv = [operands[8].to(dev) for dev in devices]
    chip_ms = chip_kernel_ms(
        k6, list(operands[:7]) + [kv, vv], mesh,
        [dict(bm=c.bm, bk=c.bk, mw=sw.merge_width, span=sw.chip_span[i],
              cspan=sw.chip_cspan[i]) for i in range(n)])
    del kv, vv
    with _Wire() as wire:
        k8(*operands, **kw)
    bound_ms, bound_by = cards_bound(chip_bounds, wire)
    ms = wall_ms(lambda: k8(*operands, **kw), devices)
    fwd_ms = wall_ms(lambda: c(a.vals, q, k, v), devices)
    one_ms = wall_ms(lambda: c1(a.vals, q, k, v), devices)
    flat_ms = wall_ms(lambda: c0(a.vals, q, k, v), devices)
    plain_ms = wall_ms(lambda: kernels.attn_fused_sharded_plain(
        *operands, **kw), devices, reps=3)
    peaks = card_peaks(lambda: c(a.vals, q, k, v), devices)

    dense_mask = bool_mask(a)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[None, None], k[None, None], v[None, None],
        attn_mask=dense_mask)[0, 0], reps=5)
    del dense_mask
    log(f"cards/o1 attention: attn_fused_sharded {ms:.4f} ms over {n} "
        f"cards (host clock, every card synchronised; K6 on each card "
        f"{', '.join(f'{t:.4f}' for t in chip_ms)} ms by its CUDA "
        f"events); the wrapper's copies between cards "
        f"{wire.total() / 1e6:.1f} MB (K and V to each card, the rows "
        f"back); forward over {n} cards {fwd_ms:.4f} ms against {n} chips "
        f"of one card {one_ms:.4f} ms and the unsharded forward "
        f"{flat_ms:.4f} ms (same clock); plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms (one card); "
        f"bound {bound_ms:.4f} ms ({bound_by}; cards "
        f"{', '.join(f'{t:.4f}' for t, _ in chip_bounds)} ms); peak memory "
        f"by card {[round(p, 3) for p in peaks]} GiB; max |kernel - plain| "
        f"{err:.3g}")
    return dict(name="attn_fused_sharded", route="cuda",
                **KERNELS["attn_fused_sharded"], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


class _HostWaits:
    """``torch.cuda.set_sync_debug_mode("warn")`` while active: every
    host wait on a card warns ("called a synchronizing CUDA operation"),
    and ``stacks`` counts each wait's Python stack (the port's and this
    script's frames, innermost first, and the innermost frame outside
    ``warnings`` where it left Python); ``other`` counts the other
    warnings' first lines, which pass on to the enclosing handler
    (``_Deterministic``'s record)."""

    SYNC = "called a synchronizing CUDA operation"

    def __enter__(self):
        import traceback
        import warnings
        self.stacks = collections.Counter()
        self.other = collections.Counter()
        self.orig = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if self.SYNC not in str(message):
                self.other[str(message).split("\n")[0][:100]] += 1
                warnings._showwarnmsg_impl(warnings.WarningMessage(
                    message, category, filename, lineno, file, line))
                return
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            ours = [f for f in frames if "repro_torch" in f.filename
                    or f.filename.endswith("chip_smoke.py")]
            keep = ours[-7:] + ([frames[-1]] if frames[-1] not in ours
                                else [])
            self.stacks[" < ".join(
                f"{Path(f.filename).name}:{f.lineno} {f.name}"
                for f in reversed(keep))] += 1
        # the switch itself may wait; the hook counts from here on
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = show
        return self

    def __exit__(self, *exc):
        import warnings
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = self.orig
        return False

    def total(self) -> int:
        return sum(self.stacks.values())


def _warm_artifacts(cfg, devices) -> None:
    """The sattn layers' attention artifact planned on every card (a
    training loop plans it at its first step): its build copies the
    mask's tables to the card, host waits outside the step."""
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models.sparse_attention import _mask_and_artifact
    for dev in dict.fromkeys(devices):
        _mask_and_artifact(MESH_SEQ, cfg.head_dim,
                           int(cfg.sparse_attn_window),
                           int(cfg.sparse_attn_global), "auto",
                           resolve_device(dev), None)


def _groups_overlap(tally, mesh) -> dict:
    """On the tally's common clock: each card's busy window and ms; for
    each data group, the least over its model chips' pairs of their
    backward spans' overlap over the shorter's busy ms (1: the chips'
    backward ran at once; 0: in turn); each group's spans and the two
    groups' overlap."""
    from repro_torch.distributed.model_split import busy, overlap
    cards = {}
    for chip, dev in enumerate(mesh.devices):
        cards.setdefault(dev, []).append(chip)
    card_busy = {}
    for dev, chips in cards.items():
        spans = tally.intervals(chips)
        card_busy[str(dev)] = (spans[0][0], spans[-1][1], busy(spans))
    groups, shares = {}, {}
    for chip in range(mesh.size):
        groups.setdefault(mesh.coords(chip)["data"], []).append(chip)
    for g, chips in groups.items():
        back = [tally.intervals([c], "backward") for c in chips]
        shares[g] = min(overlap(a, b) / max(min(busy(a), busy(b)), 1e-9)
                        for i, a in enumerate(back) for b in back[i + 1:])
    group_spans = {g: tally.intervals(c) for g, c in groups.items()}
    both = (overlap(group_spans[0], group_spans[1])
            if len(groups) > 1 else 0.0)
    return {"cards": card_busy, "shares": shares, "both": both,
            "group_busy": {g: busy(v) for g, v in group_spans.items()}}


def cards_step(n: int, shape: tuple, microbatches: int, name: str,
               inputs: tuple) -> dict:
    """(o2)/(o6) (l1)'s longformer-1.4b step on ``make_host_mesh(*shape,
    cards=n)`` and on the one-card ``shape`` mesh from the same weights,
    state and batch, both under deterministic algorithms: loss, grad
    norm, parameters and both moments bit for bit; K6 launches, bytes
    gathered and crossing cards, the model-axis sums, each chip's and
    card's spans, each group's model chips' overlap, each card's peak,
    the step's wall time and every host wait in it with its stack."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.model_split import SplitTally
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step

    t_part = time.perf_counter()
    model, initial, batch = inputs
    cfg = model.cfg
    opt = AdamW(learning_rate=TRAIN_LR)
    top = sum(math.prod(initial[k].shape) * 4
              for k in ("embed", "final_norm", "lm_head"))
    runs = {}
    for cards in (n, 1):
        mesh = make_host_mesh(data=shape[0], model=shape[1], cards=cards)
        devices = list(dict.fromkeys(mesh.devices))
        _warm_artifacts(cfg, devices)
        p_shard = sharding.param_shardings(model.param_shapes(), mesh)
        sp = sharding.shard_tree(initial, p_shard)
        state = opt.init(sp)
        sbatch = sharding.shard_tree(batch, sharding.batch_shardings(
            batch, mesh))
        tally = SplitTally(mesh, timed=True)
        step = make_train_step(model, opt, remat="full",
                               microbatches=microbatches,
                               shard_ctx={"mesh": mesh, "dp": ("data",),
                                          "tally": tally},
                               grad_shardings=p_shard)
        sharding.synchronize(devices)
        base = []
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
            base.append(torch.cuda.memory_allocated(d))
        tally.begin()
        with _Deterministic() as det, \
                _PlainCalls(("repro_torch.kernels.attn_fused",
                             "_Carry")) as plain, \
                _CardLaunches(("repro_torch.kernels.ops",
                               "attn_fused_staged")) as k6, \
                _Wire() as wire:
            t0 = time.perf_counter()
            # every host wait inside the step warns, with its stack
            with _HostWaits() as waits:
                sp, state, metrics = step(sp, state, sbatch)
            sharding.synchronize(devices)
            wall = (time.perf_counter() - t0) * 1e3
        peaks = [torch.cuda.max_memory_allocated(d) / 2 ** 30
                 for d in devices]
        held = [b / 2 ** 30 for b in base]
        assert plain.calls == 0, plain.calls
        (fwd, bwd), sum_ms = tally.chip_ms(), tally.sum_ms()
        card_ms = tally.card_ms()
        ov = _groups_overlap(tally, mesh)
        m = {k: float(v) for k, v in metrics.items()}
        firsts = {c for c in range(mesh.size)
                  if mesh.coords(c)["model"] == 0}
        per_period = [(b - (top if c in firsts else 0))
                      / (2 * cfg.num_periods * microbatches)
                      for c, b in enumerate(tally.gathered)]
        log(f"cards/{name} longformer-1.4b step on {shape} over {cards} "
            f"card(s) ({[str(d) for d in mesh.devices]}), fp32, global "
            f"batch {MESH_BATCH}, microbatches {microbatches}, S = "
            f"{MESH_SEQ}, remat full, deterministic algorithms: wall "
            f"{wall:.1f} ms (host clock, every card synchronised); loss "
            f"{m['loss']!r}, grad norm {m['grad_norm']!r}; K6 launches by "
            f"card {k6.cards(cards)}, by chip {tally.attn}; bytes gathered "
            f"a chip a period a microbatch "
            f"{[round(b / 1e6, 3) for b in per_period]} MB (the embedding, "
            f"final norm and head, {top / 1e6:.1f} MB, once a group a "
            f"microbatch besides); Tensor.to copies between cards "
            f"{wire.total() / 1e9:.3f} GB "
            f"({ {f'{s_}->{d}': round(v / 1e9, 3) for (s_, d), v in sorted(wire.moved.items())} }"
            f" GB, the card copies' gradients back included), "
            f"{wire.graded / 1e9:.3f} GB by a plain .to carrying a "
            f"gradient back (not counted); model-axis sums {tally.sums} "
            f"in {sum_ms:.4f} ms; by chip, forward and recompute "
            f"{[round(v, 1) for v in fwd]} ms, backward "
            f"{[round(v, 1) for v in bwd]} ms (CUDA events on each "
            f"chip's card); by card, in its chips' spans and sums "
            f"{ {str(d): round(v, 1) for d, v in card_ms.items()} } ms; "
            f"each card's busy window on one clock (first event, last "
            f"event, busy ms) "
            f"{ {d: tuple(round(x, 1) for x in v) for d, v in ov['cards'].items()} }; "
            f"each data group's model chips' backward overlap, over the "
            f"shorter's busy ms (least pair) "
            f"{ {g: round(v, 3) for g, v in ov['shares'].items()} }; the "
            f"groups' busy ms "
            f"{ {g: round(v, 1) for g, v in ov['group_busy'].items()} }, "
            f"overlapping {ov['both']:.1f} ms; peak memory by card "
            f"{[round(p, 2) for p in peaks]} GiB (params, moments and "
            f"batch held before the step {[round(h, 2) for h in held]} "
            f"GiB); ops without a deterministic CUDA form: "
            f"{det.warned or 'none'}; other warnings in the step "
            f"{dict(waits.other) or 'none'}; host waits on a card inside "
            f"the step {waits.total()}" + "".join(
                f"\n    {c} x {st}" for st, c in waits.stacks.most_common()))
        assert tally.attn == [384] * mesh.size, tally.attn
        if cards == n:
            assert k6.cards(n) == [384 * mesh.size // n] * n, k6.by_card
        runs[cards] = dict(metrics=m, wall=wall, peaks=peaks, ov=ov,
                           trees=(_host(sp), _host(state.mu),
                                  _host(state.nu)))
        del sp, state, metrics, sbatch, step, tally
        gc.collect()
        torch.cuda.empty_cache()
    four, one = runs[n], runs[1]
    diffs = [_leaf_diffs(a, b) for a, b in zip(four["trees"], one["trees"])]
    log(f"cards/{name} {n} cards against one card: loss "
        f"{four['metrics']['loss']!r} vs {one['metrics']['loss']!r}, grad "
        f"norm {four['metrics']['grad_norm']!r} vs "
        f"{one['metrics']['grad_norm']!r}; leaves bit for bit: "
        + "; ".join(f"{k} {s_} of {t}" for k, (s_, t, _) in
                    zip(("params", "mu", "nu"), diffs))
        + f"; wall {four['wall']:.1f} ms vs {one['wall']:.1f} ms; largest "
        f"card peak {max(four['peaks']):.2f} GiB vs {one['peaks'][0]:.2f} "
        f"GiB on one card ({time.perf_counter() - t_part:.1f} s); cards "
        f"{', '.join(card_line(i) for i in range(n))}")
    assert four["metrics"] == one["metrics"], (four["metrics"],
                                               one["metrics"])
    assert all(s_ == t for s_, t, _ in diffs), diffs
    assert max(four["peaks"]) < one["peaks"][0]
    assert four["wall"] < one["wall"], (four["wall"], one["wall"])
    return {"wall": four["wall"], "one_wall": one["wall"],
            "shares": four["ov"]["shares"]}


def cards_steps(n: int) -> dict:
    """(o2) on a (2, 2) mesh, (o6) on (1, 4) at microbatches=2 (batch 2
    in one group at once would reckon ≈ 73 GiB on one card), from the
    same weights and batch: (l1)'s."""
    _, model, params, batch = l1_inputs()
    inputs = (model, _host(params), batch)
    del params
    torch.cuda.empty_cache()
    out = {}
    for name, shape, mb in (("o2", MESH_SHAPE, 1), ("o6", (1, 4), 2)):
        try:
            out[name] = cards_step(n, shape, mb, name, inputs)
        except Exception:
            out.setdefault("failed", []).append(name)
            import traceback
            print(f"chip_smoke: part {name} failed:\n"
                  f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if "o2" in out:
        # each data group's model chips computed their backward at once
        shares = out["o2"]["shares"]
        assert all(v >= 0.5 for v in shares.values()), shares
    if "failed" in out:
        raise RuntimeError(f"parts {out['failed']} failed")
    return out


def cards_resume(n: int) -> None:
    """(o3) ``run_training`` on reduced longformer at --dp 2 --tp 2 over
    ``n`` cards: uninterrupted, and stopped at RUN_STOP, then resumed
    from the checkpoint on ``plan_remesh(2, model_parallel=1)`` over the
    surviving cuda:0..1; the same three runs on one card's meshes; losses
    and final parameters bit for bit."""
    import tempfile
    from repro_torch.configs import get_config, reduced
    from repro_torch.ft import elastic
    from repro_torch.ft.watchdog import Watchdog
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    cfg = reduced(get_config("longformer-1.4b"))
    kw = dict(steps=RUN_STEPS, global_batch=RUN_BATCH, seq_len=RUN_SEQ,
              log_every=RUN_STEPS)
    plan = elastic.plan_remesh(2, model_parallel=1)
    later = elastic.build_mesh(plan, devices=["cuda:0", "cuda:1"])
    assert later.devices == make_host_mesh(
        data=plan.mesh_shape[0], model=plan.mesh_shape[1], cards=2).devices
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp, _Deterministic():
        for cards, after in ((n, 2), (1, 1)):
            full_p, full = train.run_training(
                cfg, data_parallel=2, model_parallel=2, cards=cards,
                watchdog=Watchdog(min_deadline_s=600), **kw)
            _, first = train.run_training(
                cfg, data_parallel=2, model_parallel=2, cards=cards,
                stop_at=RUN_STOP, ckpt_dir=f"{tmp}/{cards}",
                ckpt_every=100, watchdog=Watchdog(min_deadline_s=600), **kw)
            res_p, rest = train.run_training(
                cfg, data_parallel=plan.mesh_shape[0],
                model_parallel=plan.mesh_shape[1], cards=after,
                ckpt_dir=f"{tmp}/{cards}", ckpt_every=100,
                watchdog=Watchdog(min_deadline_s=600), **kw)
            out[cards] = (full, first, rest, _host(full_p), _host(res_p))
    four, one = out[n], out[1]
    same = [_leaf_diffs(a, b) for a, b in zip(four[3:], one[3:])]
    log(f"cards/o3 run_training {cfg.name}, {RUN_STEPS} steps at batch "
        f"{RUN_BATCH}, S = {RUN_SEQ}: (2, 2) over {n} cards losses "
        f"{[f'{v:.6f}' for v in four[0]]}; stopped at {RUN_STOP} and "
        f"resumed on {plan.mesh_shape} over cuda:0..1: "
        f"{[f'{v:.6f}' for v in four[1] + four[2]]}; against one card's "
        f"(2, 2) and {plan.mesh_shape}: uninterrupted "
        f"{'bit for bit' if four[0] == one[0] else 'DIFFERENT'}, stopped "
        f"{'bit for bit' if four[1] == one[1] else 'DIFFERENT'}, resumed "
        f"{'bit for bit' if four[2] == one[2] else 'DIFFERENT'}; final "
        f"params bit for bit in {same[0][0]} of {same[0][1]} leaves "
        f"(uninterrupted) and {same[1][0]} of {same[1][1]} (resumed) "
        f"({time.perf_counter() - t0:.1f} s)")
    assert four[:3] == one[:3], (four[:3], one[:3])
    assert all(s_ == t for s_, t, _ in same), same
    assert four[1] == four[0][:RUN_STOP]


def cards_psum(n: int) -> None:
    """(o4) ``compressed_psum`` over ``n`` cards, a part on each, bit for
    bit the same call on ``n`` chips of one card; each sum on its own
    card."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(43)
    parts = [torch.from_numpy((rng.standard_normal((4096, 1024)) * (1 + c))
                              .astype(np.float32)) for c in range(n)]
    mesh = make_host_mesh(data=n, model=1, cards=n)
    with _Wire() as wire:
        sums = collectives.compressed_psum(
            [p.to(d) for p, d in zip(parts, mesh.devices)], mesh,
            axis="data")
    one = collectives.compressed_psum([p.cuda() for p in parts],
                                      make_host_mesh(data=n, model=1),
                                      axis="data")
    assert [s.device for s in sums] == list(mesh.devices)
    same = all(torch.equal(s.cpu(), o.cpu()) for s, o in zip(sums, one))
    log(f"cards/o4 compressed_psum over {n} cards, parts of "
        f"{tuple(parts[0].shape)}: every card's sum "
        f"{'bit for bit' if same else 'DIFFERENT'} the one-card chips'; "
        f"{wire.total() / 1e6:.1f} MB crossed cards (int8 payloads and "
        f"scales, and the parts placed)")
    assert same


def cards_copy_order() -> None:
    """(o5) Whether a copy between cards orders their work, as the (o2)
    step's chips ran in turn: 16 fp32 4096² matmuls on ``cuda:0``, then
    16 on ``cuda:1``, with and without a 4-byte copy from ``cuda:0`` to
    ``cuda:1`` enqueued between them (PyTorch runs a copy between cards
    behind the source card's queue and makes the destination's stream
    wait for it).  Host clock, both cards synchronised, medians of 5."""
    devices = ["cuda:0", "cuda:1"]
    gen = torch.Generator(device="cuda").manual_seed(44)
    mats = [torch.randn(4096, 4096, device="cuda", generator=gen).to(d)
            for d in devices]
    flag = torch.zeros(1, device=devices[0])

    def work(m):
        for _ in range(16):
            torch.mm(m, m)

    runs = {"cuda:0 alone": lambda: work(mats[0]),
            "both cards": lambda: (work(mats[0]), work(mats[1])),
            "both, a copy between": lambda: (work(mats[0]),
                                             flag.to(devices[1]),
                                             work(mats[1]))}
    ms = {k: wall_ms(fn, devices, reps=5) for k, fn in runs.items()}
    log("cards/o5 copy order (16 fp32 4096² matmuls a card, host clock): "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in ms.items())
        + f"; card {card_line(1)}")


def cards_main(args) -> int:
    """--cards 4: none of the default phases; (o1)-(o6) over four
    cards."""
    n = args.cards
    visible = torch.cuda.device_count()
    if visible < n:
        print(f"chip_smoke: --cards {n} needs {n} visible cards; "
              f"{visible} visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def done(name: str) -> None:
        log(f"{name}: done {time.perf_counter() - t_start:.1f} s into the run")

    phase_device()
    for i in range(n):
        log(f"card {i}: {card_line(i)}")
    log("peer access: " + "; ".join(
        f"{i}->{j} {torch.cuda.can_device_access_peer(i, j)}"
        for i in range(n) for j in range(n) if i != j))
    phase_build()
    done("build")
    from repro_torch.core import chip_mesh
    failed = []

    def part(name, fn, *args):
        """``fn(*args)``; a failure is printed and the next part runs,
        and the run then exits non-zero with no result line."""
        import traceback
        try:
            return fn(*args)
        except Exception:
            failed.append(name)
            print(f"chip_smoke: part {name} failed:\n"
                  f"{traceback.format_exc()}", file=sys.stderr, flush=True)
            return None
        finally:
            gc.collect()
            torch.cuda.empty_cache()
            done(name)

    def spmm():
        phase_sharded_fixtures(mesh_of=chip_mesh,
                               chip_counts=tuple(range(1, n + 1)))
        return cards_spmm(make_instances(), n)

    rows = part("o1 spmm", spmm) or {}
    rows["attn_fused_sharded"] = part("o1 attention", cards_attention, n)
    steps = part("o2 and o6", cards_steps, n)
    part("o3", cards_resume, n)
    part("o4", cards_psum, n)
    part("o5", cards_copy_order)
    if failed:
        print(f"chip_smoke: --cards {n}: {failed} failed", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s; the step over {n} "
        f"cards against one card: " + "; ".join(
            f"{k} {v['wall']:.1f} ms vs {v['one_wall']:.1f} ms"
            for k, v in steps.items()))
    print(json.dumps({"kernels": [rows[k] for k in SHARDED_KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def ab_main(args) -> int:
    """K1, K2, K5, K6, K7, K9 and K10 against the parent tree's
    wrappers, or only K1-K7's, K9's and K10's ptxas lines
    (``--ab-ptxas``); no smoke phases, no result line."""
    phase_device()
    parent = parent_package(args.ab_parent.resolve())
    if args.ab_ptxas:
        return 0 if ab_ptxas(parent) else 1
    instances = make_instances()
    ab_sddmm(parent, *instances["uniform"])
    ab_segment(parent, *instances["uniform"])
    ab_spmm(parent, instances)
    ab_bcsr(parent, *instances["banded"])
    del instances
    gc.collect()
    torch.cuda.empty_cache()
    ab_attention(parent)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Drive the port's main path on one H100 and check it; "
                    "with --ab-parent, time K1/K2/K5/K6/K7/K9/K10 beside "
                    "another tree's instead; with --cards 4, run the mesh "
                    "over four cards.")
    ap.add_argument("--ab-parent", type=Path, metavar="DIR",
                    help="a tree (a commit unpacked with git archive) whose "
                         "K1, K2, K5, K6, K7, K9 and K10 are timed beside "
                         "this one's through its own wrappers, in turns A B "
                         "B A, bit for bit")
    ap.add_argument("--cards", type=int, choices=[4],
                    help="run none of the default phases: K8, the "
                         "sharded training step, run_training's resume "
                         "and compressed_psum over four cards, each "
                         "against the same work on one card")
    ap.add_argument("--ab-ptxas", action="store_true",
                    help="with --ab-parent: only compare K1-K7's, K9's and "
                         "K10's ptxas registers and spills (all but K1's and "
                         "K10's must be equal)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if args.ab_ptxas and args.ab_parent is None:
        ap.error("--ab-ptxas needs --ab-parent")
    if args.ab_parent is not None:
        return ab_main(args)
    if args.cards is not None:
        return cards_main(args)
    from repro_torch.core import JitCache
    t_start = time.perf_counter()

    def done(name: str) -> None:
        log(f"{name}: done {time.perf_counter() - t_start:.1f} s into the run")

    phase_device()
    phase_build()
    phase_kernels()
    done("kernels")
    instances = make_instances()
    cache = JitCache()
    results, compiled = phase_main(instances, cache)
    done("main")
    train = phase_train(instances["uniform"][0], cache)
    done("train")
    grad = phase_grad(compiled[("uniform", "auto", None)],
                      *instances["uniform"], cache)
    done("grad")
    t_phase = time.perf_counter()
    oracles = phase_oracles(instances, compiled, grad)
    # K7's launches: the oracles path's and the backward's dvals
    oracles["sddmm"]["launches"] += grad[4]
    log(f"oracles: phase {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    sharded = phase_sharded(instances, compiled, grad, cache)
    log(f"sharded: SpMM part {time.perf_counter() - t_phase:.1f} s")
    del grad
    # an artifact holds its cache weakly, so dropping the cache frees the
    # SpMM phases' device tables at once, with no gc.collect()
    del instances, compiled, cache
    torch.cuda.empty_cache()
    log(f"memory allocated after the SpMM phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    # the serving tier; its K1-K4 launches join the main path's counts
    for name, n in phase_serve().items():
        results[name]["launches"] += n
    done("serve")
    phase_attn_kernels()
    done("attention kernels")
    attn, attn_case = phase_attention()
    done("attention")
    t_phase = time.perf_counter()
    sharded["attn_fused_sharded"] = phase_sharded_attention(*attn_case)
    del attn_case
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sharded: attention part {time.perf_counter() - t_phase:.1f} s")
    sattn = phase_sattn()
    done("sattn")
    gc.collect()
    torch.cuda.empty_cache()
    model = phase_model()
    done("model")
    gc.collect()
    torch.cuda.empty_cache()
    training = phase_training(model["jamba_peak_gib"])
    done("training")
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase_examples()
    done("examples")
    # K5/K6 launches: the attention op path's plus the layer's forward,
    # the model's and the training phase's; K4's: the main path's, the
    # serve phase's and the model's MoE layer; K3's and K8's also the
    # training driver's SpMM preflight
    for name, row in attn.items():
        row["launches"] += sattn["launches"] if name == "attn_fused_staged" \
            else 0
        row["launches"] += model.get(name, 0)
        row["launches"] += training["launches"].get(name, 0)
    results["spmm_bcsr_fused_staged"]["launches"] += \
        model["spmm_bcsr_fused_staged"]
    results["spmm_ell_fused_staged"]["launches"] += \
        training["launches"]["spmm_ell_fused_staged"]
    for name, n in examples.items():
        results[name]["launches"] += n
    results.update(attn)
    results.update(oracles)
    results.update(sharded)
    results["spmm_ell_fused_sharded"]["launches"] += \
        training["launches"]["spmm_ell_fused_sharded"]
    log("kernels: " + ", ".join(f"{r['name']} launches={r['launches']}"
                                for r in results.values())
        + f"; training: spmm_bcsr_fused_staged {train['launches']} launches "
        f"in {TRAIN_STEPS} steps, step {train['step_ms']:.4f} ms; sattn "
        f"layer: attn_fused_staged {sattn['launches']} launches a forward, "
        f"forward {sattn['fwd_ms']:.4f} ms, forward + backward "
        f"{sattn['step_ms']:.4f} ms; model: attn_fused_staged "
        f"{model['attn_fused_staged']} launches a longformer-1.4b forward, "
        f"spmm_bcsr_fused_staged {model['spmm_bcsr_fused_staged']} in the "
        f"MoE layer's routing; training: attn_fused_staged "
        f"{training['step']['launches']} launches in a longformer-1.4b step "
        f"({training['step']['ms']:.4f} ms, peak "
        f"{training['step']['peak_gib']:.2f} GiB), "
        f"{training['launches']['attn_fused_staged']} in the phase, "
        f"spmm_ell_fused_sharded "
        f"{training['launches']['spmm_ell_fused_sharded']} in the driver's "
        f"preflight; mesh: attn_fused_staged {training['mesh']['launches']} "
        f"launches in the sharded longformer-1.4b step on {MESH_SHAPE} "
        f"({training['mesh']['per_chip']} by chip; "
        f"{training['mesh']['ms']:.4f} ms, peak "
        f"{training['mesh']['peak_gib']:.2f} GiB); examples: "
        + ", ".join(f"{k} {v}" for k, v in examples.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
