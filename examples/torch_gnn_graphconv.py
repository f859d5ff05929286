"""Graph convolution with JIT-planned SpMM on the PyTorch + CUDA port —
the paper's own application domain (GNNs; §I) and the port of
``examples/gnn_graphconv.py``.  Trains a 2-layer GCN on a synthetic
community graph for node classification; the neighbourhood aggregation
Â·H is the compiled SpMM, its structure planned once and cached across
all steps.  On the card the aggregation takes the default lowering
(``pallas_bcsr`` staged: K4); on the CPU the ``ref`` backend, as the
reference picks without a TPU.

  PYTHONPATH=src python examples/torch_gnn_graphconv.py           # the card
  PYTHONPATH=src python examples/torch_gnn_graphconv.py --device cpu
  # sharded fused pallas_ell aggregation over 4 chips of the one device:
  PYTHONPATH=src python examples/torch_gnn_graphconv.py --n-chips 4
"""
import argparse

import numpy as np
import torch

from repro_torch import gnn
from repro_torch.core import ChipMesh, CSRMatrix, compile_spmm
from repro_torch.core.jit_cache import JitCache
from repro_torch.kernels.ops import resolve_device


def community_graph(N=256, D_IN=16, seed=0):
    """A synthetic 2-community graph with self loops, its sym-normalized
    Â (host arrays), noisy community-indicator features and labels."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(N) >= N // 2).astype(np.int64)
    p_in, p_out = 0.08, 0.005
    rows, cols = [], []
    for i in range(N):
        for j in range(i + 1, N):
            p = p_in if labels[i] == labels[j] else p_out
            if rng.random() < p:
                rows += [i, j]
                cols += [j, i]
    rows = np.array(rows + list(range(N)))          # + self loops
    cols = np.array(cols + list(range(N)))
    deg = np.bincount(rows, minlength=N).astype(np.float64)
    vals = (1.0 / np.sqrt(deg[rows] * deg[cols])).astype(np.float32)
    feats = rng.standard_normal((N, D_IN)).astype(np.float32)
    feats[:, 0] += labels * 2.0
    return rows, cols, vals, feats, labels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-chips", type=int, default=0,
                    help="shard the Â aggregation across this many chips "
                         "through the fused pallas_ell path (0 = the "
                         "device's default lowering)")
    ap.add_argument("--x-sharding", default="auto",
                    choices=["auto", "replicated", "rows"],
                    help="feature-matrix placement on the chip mesh: "
                         "replicated per chip, or rows = each chip fetches "
                         "exactly the H panels its rows touch (exact-panel "
                         "exchange; bit-identical either way)")
    ap.add_argument("--autotune", action="store_true",
                    help="search strategy x CGCM merge x staging per "
                         "aggregation instance instead of the fixed "
                         "nnz_split plan; the winner is memoized, so only "
                         "the first compile searches (a fused backend)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; default "
                         "the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    N, D_IN, D_H, CLASSES = 256, 16, 32, 2
    rows, cols, vals, feats, labels = community_graph(N, D_IN)
    a_hat = CSRMatrix.from_coo((N, N), rows, cols, vals, device=device)
    print(f"graph: {N} nodes, {a_hat.nnz} edges (incl self-loops)")
    X = torch.from_numpy(feats).to(device)
    y = torch.from_numpy(labels).to(device)

    # the JIT-planned aggregation operators (structure planned ONCE).
    # With --n-chips the same plan is row-partitioned across a 1-D chip
    # mesh and each chip runs its range as one fused launch.
    cache = JitCache()
    if args.n_chips:
        agg_kw = dict(backend="pallas_ell", x_sharding=args.x_sharding,
                      mesh=ChipMesh((device,) * args.n_chips))
    elif device != "cpu":
        agg_kw = dict(backend="auto")     # pallas_bcsr, staged: K4
    elif args.autotune:
        agg_kw = dict(backend="pallas_ell")   # the search needs a fused one
    else:
        agg_kw = dict(backend="ref")
    if args.autotune:
        agg_kw["autotune"] = True
    else:
        agg_kw["strategy"] = "nnz_split"
    agg_h = compile_spmm(a_hat, D_H, cache=cache, device=device, **agg_kw)
    agg_out = compile_spmm(a_hat, CLASSES, cache=cache, device=device,
                           **agg_kw)
    print(f"aggregation backend: {agg_h.backend}, staging {agg_h.staging}"
          + (f" sharded over {agg_h.mesh.size} chip(s), "
             f"x_sharding={agg_h.x_sharding}" if agg_h.mesh else ""))

    gen = torch.Generator(device=device).manual_seed(0)
    params = {"w1": torch.randn(D_IN, D_H, device=device,
                                generator=gen) * 0.2,
              "w2": torch.randn(D_H, CLASSES, device=device,
                                generator=gen) * 0.2}
    params = {k: v.requires_grad_(True) for k, v in params.items()}

    def accuracy():
        with torch.no_grad():
            logits = gnn.gcn_forward(params, agg_h, agg_out, a_hat.vals, X)
        return float((logits.argmax(-1) == y).float().mean())

    losses = []
    for epoch in range(60):
        loss = gnn.gcn_loss(params, agg_h, agg_out, a_hat.vals, X, y)
        loss.backward()
        gnn.sgd_step(params, 0.5)
        losses.append(loss.item())
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"acc {accuracy():.3f}")
    acc = accuracy()
    print(f"final accuracy: {acc:.3f} (plan cached: {cache.stats()})")
    assert acc > 0.9, "GCN should separate the two communities"
    return {"accuracy": acc, "losses": losses, "backend": agg_h.backend,
            "staging": agg_h.staging}


if __name__ == "__main__":
    main()
