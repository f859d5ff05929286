#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py        # from the repo root, one CUDA card

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device  — a Hopper card (capability 9.0); its name and power limit
             as ``nvidia-smi`` reports them.
2. build   — compile the two CUDA kernels (K1 ``spmm_ell_fused``, K2
             ``spmm_bcsr_fused``) from ``src/repro_torch/kernels/csrc``
             into ``build/``, one ``nvcc`` per source, in parallel.
3. kernels — each kernel against its plain PyTorch version on the card,
             every strategy x merge_threshold {0, 16} x d {16, 100, 128,
             640}, on a mixed VPU/MXU fixture, one with empty rows and an
             empty matrix (rtol = atol = 1e-5).
4. main    — ``compile_spmm(a, 128)`` then a forward, through the entry
             points a user calls, on two 2^20-row instances: a uniform
             graph (16.8 M edges, pure VPU trips) and a banded stencil
             (MXU trips); the uniform one also through
             ``backend="pallas_ell"`` so K1 runs at size.  Each output is
             held to the port's ``ref`` backend on the card (rtol = atol =
             1e-4), each forward must be exactly one fused dispatch and
             one kernel launch, and the kernels, their plain versions,
             the forward and ``torch.sparse.mm`` are timed.
5. report  — the launch counts, one JSON line of per-kernel numbers, and
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

KERNELS = {
    "spmm_ell_fused": dict(
        source="src/repro_torch/kernels/csrc/spmm_ell_fused.cu",
        replaces="src/repro/kernels/spmm_ell_fused.py:67"),
    "spmm_bcsr_fused": dict(
        source="src/repro_torch/kernels/csrc/spmm_bcsr_fused.cu",
        replaces="src/repro/kernels/spmm_bcsr_fused.py:63"),
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
    # the plain versions' block products must be full fp32, like the
    # reference's; TF32 would keep three digits
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


def kernel_pair(backend: str):
    from repro_torch import kernels
    if backend == "pallas_ell":
        return "spmm_ell_fused", kernels.spmm_ell_fused, \
            kernels.spmm_ell_fused_plain
    return "spmm_bcsr_fused", kernels.spmm_bcsr_fused, \
        kernels.spmm_bcsr_fused_plain


def phase_kernels() -> None:
    from repro_torch.core import CSRMatrix, JitCache, compile_spmm, random_csr
    from repro_torch.core.plan import MXU_TAG, STRATEGIES
    fixtures = {
        "mixed": CSRMatrix.from_dense(mixed_dense(0)),
        "empty_rows": random_csr(300, 256, density=0.03, family="powerlaw",
                                 seed=1),
        "empty_matrix": CSRMatrix.from_dense(np.zeros((64, 96), np.float32)),
    }
    assert np.any(fixtures["empty_rows"].row_lengths == 0)
    assert fixtures["empty_matrix"].nnz == 0
    seen = dict(merged=False, mxu=False, pad_blocks=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (fname, a), backend in itertools.product(
            fixtures.items(), ("pallas_ell", "pallas_bcsr")):
        name, kernel, plain = kernel_pair(backend)
        worst = 0.0
        for strategy, mt, d in itertools.product(STRATEGIES, (0, 16),
                                                 (16, 100, 128, 640)):
            c = compile_spmm(a, d, strategy=strategy, backend=backend,
                             merge_threshold=mt, validate="full",
                             cache=JitCache())
            ws = c.workspace
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
            y = c(a.vals, x)
            ref = a.to_dense().float() @ x
            torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
        log(f"kernel vs plain: {name} on {fname}: 24 configurations, "
            f"max |kernel - plain| = {worst:.3g} (rtol = atol = 1e-5)")
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
    name, kernel, plain = kernel_pair(c.backend)
    operands, knobs = c.fused_operands(a.vals, x)
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
    plain_ms = time_ms(lambda: plain(*operands, **knobs))
    library_ms = time_ms(lambda: torch.sparse.mm(a_sparse, x))
    log(f"{label}: {name} kernel {ms:.4f} ms, forward {fwd_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}), nnz bound {nnz_ms:.4f} ms, "
        f"gather model {gather_ms:.4f} ms, max |kernel - plain| {err:.3g}; "
        f"B={ws.num_blocks} mw={ws.merge_width} slots={vpu_slots} "
        f"mxu_blocks={int(L[mxu].sum())} d_pad={d_pad}")
    return dict(name=name, route="cuda", **KERNELS[name], max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_main() -> dict:
    from repro_torch.core import JitCache, compile_spmm, random_csr
    from repro_torch.core.plan import MXU_TAG, VPU_TAG
    from repro_torch.kernels import ops, spmm_bcsr_fused, spmm_ell_fused

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

    cache = JitCache()
    compiled = {}
    for label, backend in (("uniform", "auto"), ("banded", "auto"),
                           ("uniform", "pallas_ell")):
        a, _ = instances[label]
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        c = compile_spmm(a, D_MAIN, backend=backend, cache=cache)
        wall = time.perf_counter() - t0
        log(f"{label}/{c.backend}: compile_spmm {wall:.2f} s "
            f"(plan {ops.BUILD_SECONDS['plan']:.2f} s, pack "
            f"{ops.BUILD_SECONDS['pack']:.2f} s, validate={c.validate})")
        compiled[(label, backend)] = c
    tags = {label: compiled[(label, "auto")].workspace.blk_tag
            for label in ("uniform", "banded")}
    assert compiled[("uniform", "auto")].backend == "pallas_bcsr"
    assert np.any(tags["uniform"] == VPU_TAG), "uniform must run VPU trips"
    assert np.any(tags["banded"] == MXU_TAG), "banded must run MXU trips"

    # the main path, counted: every count is zeroed just before and read
    # just after; each forward is one dispatch and one launch
    spmm_ell_fused.launches = spmm_bcsr_fused.launches = 0
    outputs = {}
    for key, c in compiled.items():
        a, x = instances[key[0]]
        name, kernel, _ = kernel_pair(c.backend)
        ops.reset_dispatch_counts()
        before = kernel.launches
        outputs[key] = c(a.vals, x)
        dispatch = "bcsr_fused" if c.backend == "pallas_bcsr" else "ell_fused"
        assert ops.DISPATCH_COUNTS[dispatch] == 1, dict(ops.DISPATCH_COUNTS)
        assert kernel.launches == before + 1, (name, kernel.launches)
    torch.cuda.synchronize()
    launches = {"spmm_ell_fused": spmm_ell_fused.launches,
                "spmm_bcsr_fused": spmm_bcsr_fused.launches}
    log(f"main path launches: {launches}")

    for key, y in outputs.items():
        a, x = instances[key[0]]
        assert y.shape == (a.m, D_MAIN) and bool(torch.isfinite(y).all())
        ref = compile_spmm(a, D_MAIN, backend="ref", cache=cache)(a.vals, x)
        torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
        log(f"{key[0]}/{compiled[key].backend}: forward matches ref, "
            f"max |y - ref| = {(y - ref).abs().max().item():.3g} "
            f"(rtol = atol = 1e-4)")
        del ref
    del outputs
    torch.cuda.empty_cache()

    # the report's rows: K1 on the uniform graph, K2 on the banded
    # stencil; K2 on the uniform graph is printed beside them
    results = {
        "spmm_ell_fused": measure(compiled[("uniform", "pallas_ell")],
                                  *instances["uniform"], "uniform"),
        "spmm_bcsr_fused": measure(compiled[("banded", "auto")],
                                   *instances["banded"], "banded")}
    measure(compiled[("uniform", "auto")], *instances["uniform"], "uniform")
    for name, row in results.items():
        row["launches"] = launches[name]
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    phase_device()
    phase_build()
    phase_kernels()
    results = phase_main()
    log("kernels: " + ", ".join(f"{r['name']} launches={r['launches']}"
                                for r in results.values()))
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
