"""End-to-end training on the PyTorch + CUDA port: an LM through the
full stack (data pipeline -> sharded train step -> checkpoints ->
watchdog) — the port of ``examples/train_lm.py``.

A reduced MoE config by default (so the MoE-as-SpMM path runs), on the
card or the CPU, over a ``(--dp, --tp)`` mesh of chips on that device:
the batch splits over the data axis, and the model axis splits heads,
``d_ff``, experts and vocabulary over its chips.  ``--full`` takes the
full config.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
      --steps 20 --dp 2 --tp 2
"""
import argparse
import tempfile

from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import run_training


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--dp", type=int, default=1,
                    help="data axis of the mesh: the batch splits over it")
    ap.add_argument("--tp", type=int, default=1,
                    help="model axis: heads, d_ff, experts and vocabulary "
                         "split over its chips")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default the CUDA card")
    ap.add_argument("--full", action="store_true",
                    help="full config (the card; the CPU uses the reduced "
                         "scale)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced(
        get_config(args.arch))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        _, losses = run_training(
            cfg, steps=args.steps, global_batch=args.batch,
            seq_len=args.seq, ckpt_dir=ckpt_dir, ckpt_every=100,
            log_every=25, data_parallel=args.dp, model_parallel=args.tp,
            device=args.device)
    drop = losses[0] - min(losses)
    print(f"[train_lm] {cfg.name}: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} (best drop {drop:.3f} over {args.steps} steps)")
    assert losses[-1] < losses[0], "loss must decrease"
    return losses


if __name__ == "__main__":
    main()
