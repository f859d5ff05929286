"""End-to-end training driver (port of ``src/repro/launch/train.py``):
data pipeline -> train step -> checkpoint/restart + watchdog straggler
mitigation, on the card (``device=None``) or the CPU (``"cpu"``), over a
``(data_parallel, model_parallel)`` mesh of chips on that device, or
with ``cards`` > 1 laid out over that many cards, each a contiguous run
of chips (``launch.mesh.make_host_mesh``; ``--cards 4`` on ``--dp 2 --tp
2`` gives each chip a card): parameters, optimizer state and batch
placed by ``distributed.sharding``'s rules, the data groups enqueued in
turn and computing at once where they lie on cards of their own
(``train.train_step``), each over its model chips: ``--tp`` splits
compute as GSPMD's Megatron split does (heads, ``d_ff``, experts and
vocabulary per chip, ``distributed/model_split.py``).

Before step 0 it validates the kernels the run leans on: a config with
``sattn`` slots pushes one head of its own mask through the default
lowering (K6 on the card) against ``ref`` (``sparse_attn_preflight``),
and ``--spmm-chips`` runs the sharded fused SpMM (K8 over K1-K4) against
``ref`` (``spmm_shard_preflight``).  Each step ends in a read of its
loss and waits for every card of the mesh, so the watchdog times the
whole step, not its launches.  Initial weights come from a generator seeded with ``seed`` on
the run's device: the port's own draws, not the reference's (JAX's RNG).

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --smoke --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
      --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch longformer-1.4b \\
      --smoke --device cpu --steps 3 --batch 4 --dp 2 --tp 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch longformer-1.4b \\
      --smoke --steps 3 --batch 4 --dp 2 --tp 2 --cards 4
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config, reduced
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..distributed.sharding import (batch_shardings, gather_tree,
                                    param_shardings, shard_tree,
                                    synchronize)
from ..ft import checkpoint as ckpt
from ..ft.watchdog import StepTimeout, Watchdog
from ..kernels.ops import resolve_device
from ..models.model import Model
from ..optim.adamw import AdamW, warmup_cosine
from ..train.train_step import make_train_step
from .mesh import make_chip_mesh, make_host_mesh


def spmm_shard_preflight(n_chips: int, backend: str = "pallas_ell",
                         x_sharding: str = "auto", autotune: bool = False,
                         *, device=None) -> int:
    """Validate the sharded fused SpMM path before committing to a long
    run: a small sharded plan on ``n_chips`` chips of ``device``'s kind
    (the card's, raising when fewer exist; ``"cpu"``: CPU chips) checked
    against the ``ref`` backend.  ``backend`` is the fused dispatch the
    run will use, ``x_sharding`` the X placement (``"auto"`` resolves as
    the run would), and ``autotune=True`` also runs the plan search on
    the fixture."""
    from ..core import (FUSED_BACKENDS, JitCache, X_SHARDING_MODES,
                        random_csr, spmm)
    if backend not in FUSED_BACKENDS:
        raise ValueError(
            f"--spmm-backend must be one of {FUSED_BACKENDS}, "
            f"got {backend!r}")
    if x_sharding not in ("auto", *X_SHARDING_MODES):
        raise ValueError(
            f"--x-sharding must be 'auto' or one of {X_SHARDING_MODES}, "
            f"got {x_sharding!r}")
    device = resolve_device(device)
    mesh = make_chip_mesh(n_chips, device)
    a = random_csr(96, 64, density=0.08, family="powerlaw", seed=0,
                   device=device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 16)).astype(np.float32)).to(device)
    cache = JitCache()
    y = spmm(a, x, strategy="nnz_split", backend=backend, device=device,
             mesh=mesh, x_sharding=x_sharding, cache=cache)
    y_ref = spmm(a, x, strategy="nnz_split", backend="ref", device=device,
                 cache=cache)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    if autotune:
        y_t = spmm(a, x, backend=backend, device=device, mesh=mesh,
                   x_sharding=x_sharding, autotune=True, cache=cache)
        torch.testing.assert_close(y_t, y_ref, rtol=1e-4, atol=1e-4)
    print(f"[train] spmm shard preflight OK on {n_chips} chip(s) "
          f"({backend}, x_sharding={x_sharding}"
          f"{', autotuned' if autotune else ''})", flush=True)
    return n_chips


def sparse_attn_preflight(cfg, seq_len: int, *, device=None) -> None:
    """Validate the fused sparse-attention sandwich (DESIGN.md §13) for a
    config with ``sattn`` slots before committing to a run: the run's own
    mask at min(seq_len, 128), one (Q, K, V) head through the default
    lowering (the card's: ``pallas_bcsr``/``dma``, K6) against the
    ``ref`` backend."""
    from ..core import compile_sparse_attention
    from ..models.sparse_attention import sparse_attention_mask
    device = resolve_device(device)
    S = min(seq_len, 128)
    a = sparse_attention_mask(S, cfg.sparse_attn_window,
                              cfg.sparse_attn_global, device=device)
    rng = np.random.default_rng(0)
    hd = cfg.head_dim
    q, k, v = (torch.from_numpy(rng.standard_normal((S, hd)).astype(
        np.float32)).to(device) for _ in range(3))
    vals = torch.ones(a.nnz, dtype=torch.float32, device=device)
    y = compile_sparse_attention(a, hd, device=device)(vals, q, k, v)
    y_ref = compile_sparse_attention(a, hd, backend="ref",
                                     device=device)(vals, q, k, v)
    torch.testing.assert_close(y, y_ref, rtol=1e-4, atol=1e-4)
    print(f"[train] sparse-attention preflight OK "
          f"(S={S}, window={cfg.sparse_attn_window}, "
          f"global={cfg.sparse_attn_global}, nnz={a.nnz})", flush=True)


def run_training(cfg, *, steps: int, global_batch: int, seq_len: int,
                 ckpt_dir=None, ckpt_every: int = 20, lr: float = 3e-4,
                 microbatches: int = 1, remat: str = "full",
                 data_parallel: int = 1, model_parallel: int = 1,
                 cards: int = 1, spmm_chips: int = 0, spmm_backend: str = "pallas_ell",
                 spmm_x_sharding: str = "auto", spmm_autotune: bool = False,
                 log_every: int = 10, fault_injector=None,
                 watchdog: Watchdog = None, seed: int = 0,
                 stop_at: int = None, device=None):
    """Train ``cfg`` for ``steps`` steps (or up to ``stop_at``) -> (final
    params, the losses of the steps run).  With ``ckpt_dir`` it resumes
    from the latest checkpoint there (params; optimizer state under
    ``ckpt_dir/opt``), saves every ``ckpt_every`` steps and at the end;
    a ``StepTimeout`` restores the last checkpoint (or retries the step
    when there is none).  The returned params are gathered whole."""
    device = resolve_device(device)
    mesh = make_host_mesh(data=data_parallel, model=model_parallel,
                          device=device, cards=cards)
    model = Model(cfg)
    if spmm_chips:
        spmm_shard_preflight(spmm_chips, spmm_backend, spmm_x_sharding,
                             autotune=spmm_autotune, device=device)
    if "sattn" in cfg.pattern:
        sparse_attn_preflight(cfg, seq_len, device=device)
    opt = AdamW(learning_rate=warmup_cosine(lr, min(20, steps // 10 + 1),
                                            steps))
    param_meta = model.param_shapes()
    p_shard = param_shardings(param_meta, mesh)
    # the step count stays a plain tensor on the device, as AdamW keeps it
    o_shard = param_shardings(opt.init(param_meta), mesh)._replace(
        count=None)
    step_fn = make_train_step(model, opt, remat=remat,
                              microbatches=microbatches,
                              chunk_q=max(64, seq_len // 4),
                              shard_ctx={"mesh": mesh, "dp": ("data",)},
                              grad_shardings=p_shard)

    def step_synced(params, opt_state, batch):
        # the float() reads wait for the metrics' card and synchronize
        # for the others: the watchdog times the whole step
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        synchronize(mesh.devices)
        return params, opt_state, metrics

    pipe = TokenPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        num_image_tokens=cfg.num_image_tokens
        if cfg.family == "vlm" else 0, d_model=cfg.d_model))

    b_shard = batch_shardings(pipe.batch_at(0), mesh)
    # init whole, then shard: the starting params do not depend on the
    # mesh (the reference's init-then-device_put, for the same reason)
    params = shard_tree(model.init(torch.Generator(device=device).manual_seed(
        seed), device=device), p_shard)
    opt_state = opt.init(params)

    def restore():
        return (ckpt.restore_checkpoint(ckpt_dir, param_meta,
                                        shardings=p_shard),
                ckpt.restore_checkpoint(Path(ckpt_dir) / "opt",
                                        opt.init(param_meta),
                                        shardings=o_shard, device=device))

    start_step = 0
    if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
        start_step = ckpt.latest_step(ckpt_dir)
        params, opt_state = restore()
        print(f"[train] resumed from step {start_step}", flush=True)

    wd = watchdog or Watchdog()
    losses = []
    step = start_step
    end_step = min(steps, stop_at) if stop_at is not None else steps
    while step < end_step:
        try:
            params, opt_state, metrics = wd.run_step(
                step_synced, params, opt_state,
                shard_tree({k: torch.from_numpy(v) for k, v in
                            pipe.batch_at(step).items()}, b_shard),
                fault_injector=fault_injector)
        except StepTimeout as e:
            print(f"[train] step {step}: {e}; restoring last checkpoint",
                  flush=True)
            if ckpt_dir is None or ckpt.latest_step(ckpt_dir) is None:
                continue                     # nothing to restore: retry
            step = ckpt.latest_step(ckpt_dir)
            params, opt_state = restore()
            continue
        losses.append(metrics["loss"])
        if step % log_every == 0:
            print(f"[train] step {step} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f}", flush=True)
        step += 1
        if ckpt_dir is not None and step % ckpt_every == 0:
            ckpt.save_checkpoint(ckpt_dir, step, params)
            ckpt.save_checkpoint(Path(ckpt_dir) / "opt", step, opt_state)
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, step, params)
        ckpt.save_checkpoint(Path(ckpt_dir) / "opt", step, opt_state)
    return gather_tree(params, device), losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Train an architecture on the token pipeline.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the kernels' plain versions; default "
                         "the CUDA card")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["none", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--dp", type=int, default=1,
                    help="data axis of the mesh: the batch splits over it")
    ap.add_argument("--tp", type=int, default=1,
                    help="model axis of the mesh: each model chip "
                         "computes its own heads, d_ff columns, experts "
                         "and vocabulary rows")
    ap.add_argument("--cards", type=int, default=1,
                    help="CUDA cards the dp x tp chips are laid out over, "
                         "each card a contiguous run of chips (must "
                         "divide dp x tp)")
    ap.add_argument("--spmm-chips", type=int, default=0,
                    help="validate the sharded fused SpMM path on this "
                         "many chips before training (0 = skip)")
    ap.add_argument("--spmm-backend", default="pallas_ell",
                    choices=["pallas_ell", "pallas_bcsr"],
                    help="fused SpMM dispatch the preflight validates")
    ap.add_argument("--x-sharding", default="auto",
                    choices=["auto", "replicated", "rows"],
                    help="X placement the preflight validates on the chip "
                         "mesh (DESIGN.md §7.8); auto matches the run")
    ap.add_argument("--autotune", action="store_true",
                    help="preflight also runs the per-instance SpMM plan "
                         "search and validates the winner")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    t0 = time.time()
    _, losses = run_training(
        cfg, steps=args.steps, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
        microbatches=args.microbatches, remat=args.remat,
        data_parallel=args.dp, model_parallel=args.tp, cards=args.cards,
        spmm_chips=args.spmm_chips, spmm_backend=args.spmm_backend,
        spmm_x_sharding=args.x_sharding, spmm_autotune=args.autotune,
        device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f} ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
