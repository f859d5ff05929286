#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device  — a Hopper card (capability 9.0); its name and power limit
             as ``nvidia-smi`` reports them.
2. build   — compile the six CUDA kernels (K1 ``spmm_ell_fused``, K2
             ``spmm_bcsr_fused``, K3 ``spmm_ell_fused_staged``, K4
             ``spmm_bcsr_fused_staged``, K5 ``attn_fused``, K6
             ``attn_fused_staged``) from ``src/repro_torch/kernels/csrc``
             into ``build/``, one ``nvcc`` per source, in parallel, and
             print ptxas's registers and spills for every bm instance.
3. kernels — each kernel against its plain PyTorch version on the card
             (rtol = atol = 1e-5), and each staged kernel against its
             resident twin (``torch.equal``: K3 = K1, K4 = K2): every
             strategy x merge_threshold {0, 16} x d {16, 100, 128, 640},
             on a mixed VPU/MXU fixture, one with empty rows and an empty
             matrix, also with a 64-entry staging slot; plus a hub row
             and a dense 8-row block-row whose windows exceed the slot
             (and shared memory), which must take the chunked walk.
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
             ``torch.sparse.mm`` are timed.
5. train   — the 2-layer GCN of ``examples/gnn_graphconv.py`` at full
             width on the uniform graph plus self-loops (sym-normalised,
             ~17.8 M edges): 5 SGD steps with the default artifacts, 4
             staged launches and no dvals work a step, a falling loss,
             and step 0's weight gradients held to the ``ref`` backend
             (rtol = atol = 1e-4); the step time is printed.
6. grad    — dvals and dX of ``(A·X * G).sum()`` on the uniform graph
             through the default artifact, held to ``ref`` at 1e-4.
7. attention kernels — K5 and K6 against their plain versions on the
             card (rtol = atol = 1e-5) and K6 against K5 (``torch.equal``)
             on the reference's weighted powerlaw mask, its multi-trip
             fixture (q x 12), its empty-rows fixture and a fixture whose
             windows exceed the staging slot, each backend x
             merge_threshold {0, 16} x bm {1, 2, 4, 8, 16}.
8. attention — ``compile_sparse_attention`` on the longformer-1.4b mask
             (S = 32768, window 512, 64 global columns, 18.7 M nonzeros),
             one head, dh = dv = 128: ``pallas_bcsr`` and ``pallas_ell``
             with the default staging (``dma``: K6) and ``resident``
             (K5), one dispatch and one launch a forward, each held to
             the port's ``ref`` backend at 1e-4 and each staged output to
             the resident one bit for bit; kernel, forward, plain version
             and ``scaled_dot_product_attention`` with the dense boolean
             mask (the library yardstick) timed beside the bounds.
9. sattn   — the longformer-1.4b ``sattn`` layer at full width (d_model
             2048, 16 heads over 16 KV heads, head_dim 128, S = 4096,
             batch 1, float32, random weights from a seed): 16 K6 launches
             a forward; output and weight gradients held to the
             ``backend="ref"`` layer at 1e-4; forward and forward +
             backward timed; the backward's peak memory printed, and no
             kernel's plain version run on the way.
10. report — the launch counts, one JSON line of per-kernel numbers, and
             the final ``{"ok": true, ...}`` line.

It writes nothing into the repo but the kernel build under ``build/``.
"""
from __future__ import annotations

import gc
import itertools
import json
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
}
SPMM_KERNELS = tuple(KERNELS)[:4]
ATTN_KERNELS = tuple(KERNELS)[4:]

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


def phase_device() -> None:
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs a Hopper card (9, 0), "
                         f"got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)    # nvidia-smi's own line: the card's name, its power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device count {torch.cuda.device_count()}")
    # the GCN's dense products run in full fp32, as the reference's do;
    # TF32 would keep three digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall; per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name, text in _build.BUILD_LOG.items():
        # ptxas -v: per template instance (bm), registers and spills
        report, bm = [], "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                bm = re.search(r"ILi(\d+)E", line).group(1)
            elif "spill stores" in line:
                spill = line.split(",")[1].strip()
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                report.append(f"bm={bm}: {regs} registers, {spill}")
        log(f"ptxas {name}: " + "; ".join(report))


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
    from repro_torch.core.plan import MXU_TAG, STRATEGIES
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
    for (fname, (a, ds, caps, bms)), backend in itertools.product(
            fixtures.items(), ("pallas_ell", "pallas_bcsr")):
        name, kernel, plain = kernel_pair(backend, "resident")
        sname, staged, splain = kernel_pair(backend, "dma")
        worst = worst_staged = 0.0
        configs = 0
        for strategy, mt, d, bm in itertools.product(STRATEGIES, (0, 16), ds,
                                                     bms):
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


def bound(operands, out_elems: int, vpu_slots: int, mxu_macs_per_col: int,
          d_pad: int):
    """The least time the card could take for the launch: each input
    byte read once and the output written once over the HBM rate, or the
    fp32 operations these inputs need over the fp32 rate — the larger."""
    nbytes = sum(t.numel() * t.element_size() for t in operands)
    nbytes += out_elems * 4
    flops = 2.0 * (vpu_slots + mxu_macs_per_col) * d_pad
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(c, a, x, label: str) -> dict:
    """Hold the kernel to its plain version at size, time the forward,
    the kernel, the plain version and torch.sparse.mm, print them with
    the bounds, and return the kernel's row of the JSON report."""
    from repro_torch.core.plan import MXU_TAG
    name, kernel, plain = kernel_pair(c.backend, c.staging)
    operands, knobs = c.fused_operands(a.vals, x)
    if c.staging == "dma":
        knobs.update(windows(c))
    got = kernel(*operands, **knobs)
    want = plain(*operands, **knobs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
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
    # the gather model: every VPU slot reads its own X row from HBM
    gather_ms = (vpu_slots * (8 + 4 * d_pad) + mxu_macs * 4
                 + out_elems * 4) / HBM_BYTES_PER_S * 1e3
    # the structure's own floor, whatever the workspace: A's values and
    # columns (f32 + i32 per nonzero), X read once, Y written once; the
    # workspace bound above also pays for ELL and block padding
    nnz_ms = (a.nnz * 8 + (a.n + a.m) * x.shape[1] * 4) \
        / HBM_BYTES_PER_S * 1e3
    crow = torch.from_numpy(a.row_ptr).cuda()
    col = torch.from_numpy(a.col_indices.astype(np.int64)).cuda()
    a_sparse = torch.sparse_csr_tensor(crow, col, a.vals, size=a.shape,
                                       check_invariants=False)
    fwd_ms = time_ms(lambda: c(a.vals, x))
    ms = time_ms(lambda: kernel(*operands, **knobs))
    plain_ms = time_ms(lambda: plain(*operands, **knobs), reps=5)
    library_ms = time_ms(lambda: torch.sparse.mm(a_sparse, x))
    log(f"{label}/{c.backend}/{c.staging}: {name} kernel {ms:.4f} ms, "
        f"forward {fwd_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), nnz bound {nnz_ms:.4f} ms, gather model "
        f"{gather_ms:.4f} ms, max |kernel - plain| {err:.3g}; "
        f"B={ws.num_blocks} mw={ws.merge_width} slots={vpu_slots} "
        f"mxu_blocks={int(L[mxu].sum())} d_pad={d_pad} "
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
    return results, compiled


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


def phase_grad(c, a, x, cache) -> None:
    """dvals and dX through the default artifact at size, held to ref."""
    from repro_torch.core import compile_spmm
    gen = torch.Generator(device="cuda").manual_seed(4)
    g = torch.randn(a.m, D_MAIN, device="cuda", generator=gen)
    grads = []
    for art in (c, compile_spmm(a, D_MAIN, backend="ref", cache=cache)):
        vals = a.vals.clone().requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        (art(vals, xx) * g).sum().backward()
        grads.append((vals.grad, xx.grad))
    (dv, dx), (dv_ref, dx_ref) = grads
    torch.testing.assert_close(dv, dv_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-4)
    log(f"grad: {c.backend}/{c.staging} dvals max |diff| "
        f"{(dv - dv_ref).abs().max().item():.3g}, dX max |diff| "
        f"{(dx - dx_ref).abs().max().item():.3g} vs ref "
        f"(rtol = atol = 1e-4)")


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


def phase_attn_kernels() -> None:
    """K5 and K6 against their plain versions, K6 against K5."""
    from repro_torch.core import CSRMatrix, JitCache, compile_sparse_attention
    from repro_torch.core.plan import MXU_TAG
    from repro_torch.kernels import (attn_fused, attn_fused_plain,
                                     attn_fused_staged,
                                     attn_fused_staged_plain)
    from repro_torch.kernels.spmm_ell_fused import (staged_walk,
                                                    staging_geometry)
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
    seen = dict(merged=False, mxu=False, chunked_vpu=False,
                chunked_mxu=False, unaligned=False)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = worst_staged = worst_fwd = 0.0
    configs = 0
    for (fname, (a, dh, dv, scale)), backend, mt, bm in itertools.product(
            fixtures.items(), ("pallas_ell", "pallas_bcsr"), (0, 16),
            (1, 2, 4, 8, 16)):
        c = compile_sparse_attention(a, dh, dv, backend=backend, bm=bm,
                                     merge_threshold=mt, staging="resident",
                                     validate="full", cache=JitCache())
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
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
        assert torch.equal(got_s, got), (fname, backend, mt, bm)
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
        seen["mxu"] |= bool(np.any(ws.blk_tag == MXU_TAG))
        seen["unaligned"] |= bool(np.any(ws.blk_off % 4))
        geo = staging_geometry(ws.max_span, ws.max_cspan, bm=bm, bk=c.bk)
        tables = [torch.from_numpy(t).long() for t in
                  (ws.blk_tag, ws.blk_off, ws.blk_coff, ws.blk_L)]
        kinds = {it[0] for it in staged_walk(
            *tables, bm=bm, bk=c.bk, mw=ws.merge_width, c=geo[0], ch=geo[1],
            kc=geo[2])}
        seen["chunked_vpu"] |= "vpu" in kinds
        seen["chunked_mxu"] |= "mxu" in kinds
    log(f"attention kernels: {configs} configurations; attn_fused: max "
        f"|kernel - plain| = {worst:.3g}; attn_fused_staged: bit-identical "
        f"to attn_fused, max |kernel - plain| = {worst_staged:.3g} (rtol = "
        f"atol = 1e-5); forwards vs ref max |diff| {worst_fwd:.3g} (1e-5)")
    missing = [k for k, v in seen.items() if not v]
    if missing:
        raise SystemExit(f"chip_smoke: attention fixtures never reached "
                         f"{missing}")


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


def phase_attention() -> dict:
    """compile_sparse_attention on the longformer-1.4b mask, one head."""
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
    rows = torch.from_numpy(np.repeat(np.arange(a.m), a.row_lengths)).cuda()
    cols = torch.from_numpy(a.col_indices.astype(np.int64)).cuda()
    dense_mask = torch.zeros((a.m, a.n), dtype=torch.bool, device="cuda")
    dense_mask[rows, cols] = True
    del rows, cols

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
    return {name: results[name] for name in ATTN_KERNELS}


class _PlainCalls:
    """Counts the attention kernels' plain versions while it is active
    (each builds one ``_Carry``): the card's path must run none."""

    def __enter__(self):
        import importlib
        mod = importlib.import_module("repro_torch.kernels.attn_fused")
        self.mod, self.orig, self.calls = mod, mod._Carry, 0
        outer = self

        class Counted(self.orig):
            def __init__(self, *args, **kw):
                outer.calls += 1
                super().__init__(*args, **kw)

        mod._Carry = Counted
        return self

    def __exit__(self, *exc):
        self.mod._Carry = self.orig
        return False


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
    with _PlainCalls() as plain:
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
    return dict(launches=forward["attn_fused_staged"], fwd_ms=fwd_ms,
                step_ms=step_ms, peak=peak)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import JitCache
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_kernels()
    instances = make_instances()
    cache = JitCache()
    results, compiled = phase_main(instances, cache)
    train = phase_train(instances["uniform"][0], cache)
    phase_grad(compiled[("uniform", "auto", None)], *instances["uniform"],
               cache)
    # the artifacts and their cache reference each other: collect the
    # cycles so the SpMM phases' device tables are freed here
    del instances, compiled, cache
    gc.collect()
    torch.cuda.empty_cache()
    log(f"memory allocated after the SpMM phases: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    phase_attn_kernels()
    attn = phase_attention()
    sattn = phase_sattn()
    # K5/K6 launches: the attention op path's plus the layer's forward
    for name, row in attn.items():
        row["launches"] += sattn["launches"] if name == "attn_fused_staged" \
            else 0
    results.update(attn)
    log("kernels: " + ", ".join(f"{r['name']} launches={r['launches']}"
                                for r in results.values())
        + f"; training: spmm_bcsr_fused_staged {train['launches']} launches "
        f"in {TRAIN_STEPS} steps, step {train['step_ms']:.4f} ms; sattn "
        f"layer: attn_fused_staged {sattn['launches']} launches a forward, "
        f"forward {sattn['fwd_ms']:.4f} ms, forward + backward "
        f"{sattn['step_ms']:.4f} ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
