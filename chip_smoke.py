#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device  — a Hopper card (capability 9.0); its name and power limit
             as ``nvidia-smi`` reports them.
2. build   — compile the four CUDA kernels (K1 ``spmm_ell_fused``, K2
             ``spmm_bcsr_fused``, K3 ``spmm_ell_fused_staged``, K4
             ``spmm_bcsr_fused_staged``) from ``src/repro_torch/kernels/
             csrc`` into ``build/``, one ``nvcc`` per source, in parallel,
             and print ptxas's registers and spills for each.
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
7. report  — the launch counts, one JSON line of per-kernel numbers, and
             the final ``{"ok": true, ...}`` line.

It writes nothing into the repo but the kernel build under ``build/``.
"""
from __future__ import annotations

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
}


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
    for name in KERNELS:
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
    launches = {name: getattr(kernels, name).launches for name in KERNELS}
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
    log("kernels: " + ", ".join(f"{r['name']} launches={r['launches']}"
                                for r in results.values())
        + f"; training: spmm_bcsr_fused_staged {train['launches']} launches "
        f"in {TRAIN_STEPS} steps, step {train['step_ms']:.4f} ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
