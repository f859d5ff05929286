"""Quickstart on the PyTorch + CUDA port: JIT-specialized SpMM in 30
lines (the port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (GLOBAL_CACHE, build_plan, compile_spmm,
                              random_csr, spmm)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)
    dev = args.device
    # a skewed (power-law) sparse matrix — the case that motivates the
    # paper's workload-division strategies
    a = random_csr(1024, 1024, density=0.02, family="powerlaw", seed=0,
                   device=dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1024, 45)).astype(np.float32)).to(a.vals.device)
    print(f"A: {a.shape}, nnz={a.nnz}, fingerprint={a.fingerprint[:12]}…")

    # plan-time = the paper's JIT codegen time: what each strategy does
    for strategy in ("row_split", "nnz_split", "merge_split"):
        plan = build_plan(a.row_ptr, a.col_indices, a.shape, 45,
                          strategy=strategy)
        print(f"  {strategy:12s} -> {plan.stats()}")

    # one-shot API (plans + compiles on first call; cached thereafter)
    y = spmm(a, x, strategy="nnz_split", backend="ref", device=dev)
    dense_ok = bool(torch.allclose(y, a.to_dense() @ x, atol=1e-3))
    print("Y:", tuple(y.shape), "matches dense:", dense_ok)

    # the fused ELL kernel: K3 (staged) on the card, its plain version on
    # the CPU
    y_k = spmm(a, x, strategy="nnz_split", backend="pallas_ell", device=dev)
    fused_ok = bool(torch.allclose(y_k, y, atol=1e-3))
    print("pallas_ell matches:", fused_ok)

    # the jit-function cache (paper Table IV): second call is a pure hit
    compile_spmm(a, 45, strategy="nnz_split", backend="ref", device=dev)
    print("cache:", GLOBAL_CACHE.stats())
    assert dense_ok and fused_ok
    return {"dense_ok": dense_ok, "fused_ok": fused_ok}


if __name__ == "__main__":
    main()
