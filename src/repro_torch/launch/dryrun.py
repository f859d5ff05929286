"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device (port
of ``src/repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step with XLA over 512
placeholder host devices, and reads the compiled artifact's memory and
cost analyses.  An eager PyTorch program has no compiled artifact, so
the port's dry run is its nearest counterpart, with no compile and no
allocation: the step's inputs as ``meta`` tensors (``Model.param_shapes``,
``AdamW.init`` on them, ``Model.input_specs``), their placements on the
mesh (``distributed.sharding``), and from those

  argument_bytes_per_chip  each input's shard on one chip, summed: the
                           counterpart of ``memory_analysis()
                           .argument_size_in_bytes`` (its ``breakdown``
                           by tree)
  model_flops              ``analysis.roofline.model_flops_for_cell``
  hbm_traffic              ``analysis.memmodel.hbm_traffic``'s terms per
                           chip, and ``memory_s`` at the card's rate
  compute_s, bottleneck    the model FLOPs spread over the chips at the
                           card's peak for the config's dtype
                           (``roofline.peak_flops``: the bf16 tensor-core
                           rate, as the reference costs its chip's bf16
                           matrix unit, or float32's), against
                           ``memory_s``
  arguments_fit_card       on the ``card`` mesh: whether the arguments
                           alone fit in the card's 80 GiB (activations
                           and gradients are not counted: a step's peak
                           is larger)

over the meshes ``single`` (16 x 16), ``multi`` (2 x 16 x 16) and
``card`` (1 x 1).  The reference's XLA-only flags (``--variant``'s
layout hints, the ``--chunk-q`` cost probes, ``--remat``,
``--microbatches``, ``--tag``, ``--skip-existing``) have nothing to
measure here and are not ported.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k --mesh multi --out artifacts/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out artifacts/dryrun_torch      # every cell on every mesh
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from ..analysis.memmodel import hbm_traffic, memory_seconds
from ..analysis.roofline import model_flops_for_cell, peak_flops
from ..configs import SHAPES, all_arch_names, cell_supported, get_config
from ..distributed.sharding import (LogicalMesh, batch_shardings,
                                    decode_shardings, param_shardings,
                                    placed_bytes)
from ..models.model import Model
from ..optim.adamw import AdamW
from .mesh import make_production_mesh

CARD_BYTES = 80 * 2 ** 30          # one H100's device memory
MESHES = ("single", "multi", "card")
MESH_NAMES = {"single": "pod16x16", "multi": "pod2x16x16", "card": "card1x1"}


def make_mesh(name: str) -> LogicalMesh:
    """The named mesh, its chips on ``meta``."""
    if name == "card":
        return LogicalMesh(("data", "model"), (1, 1), ("meta",))
    return make_production_mesh(multi_pod=name == "multi")


def cell_arguments(model: Model, shape, mesh: LogicalMesh) -> dict:
    """Per-chip bytes of the step's arguments, by tree: parameters, and
    the optimizer state and batch (train), the tokens (prefill), or the
    token, caches and position (decode)."""
    params = model.param_shapes()
    out = {"params": placed_bytes(params, param_shardings(params, mesh))}
    if shape.kind == "train":
        opt = AdamW().init(params)
        out["opt_state"] = placed_bytes(opt, param_shardings(opt, mesh))
        batch = model.input_specs(shape)
        out["batch"] = placed_bytes(batch, batch_shardings(batch, mesh))
    elif shape.kind == "prefill":
        batch = model.input_specs(shape)
        out["batch"] = placed_bytes(batch, batch_shardings(batch, mesh))
    else:
        specs = model.input_specs(shape)
        out["decode_inputs"] = placed_bytes(
            specs, decode_shardings(specs, mesh))
    return out


def dryrun_cell(arch: str, shape_name: str, mesh_name: str, *,
                out_dir=None, cfg=None, shape=None) -> dict:
    """One cell's record.  ``cfg`` and ``shape`` replace the registered
    architecture and shape (a cut or a run's own batch), as the
    reference's ``cfg_override`` does."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    cell_id = f"{arch}__{shape_name}__{MESH_NAMES[mesh_name]}"
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH_NAMES[mesh_name],
           "status": ""}
    supported, reason = cell_supported(cfg, shape)
    if not supported:
        rec.update(status="skip", reason=reason)
        _write(rec, out_dir, cell_id)
        return rec
    t0 = time.perf_counter()
    try:
        mesh = make_mesh(mesh_name)
        chips = mesh.size
        args = cell_arguments(Model(cfg), shape, mesh)
        arg_bytes = sum(args.values())
        mf = model_flops_for_cell(cfg, shape)
        traffic = hbm_traffic(cfg, shape, mesh)
        memory_s = memory_seconds(cfg, shape, mesh)
        compute_s = mf / (chips * peak_flops(cfg.dtype))
        rec.update(
            status="ok", chips=chips, build_s=time.perf_counter() - t0,
            argument_bytes_per_chip=arg_bytes, breakdown=args,
            model_flops=mf, hbm_traffic_per_chip=traffic,
            memory_s=memory_s, compute_s=compute_s,
            bottleneck="compute" if compute_s >= memory_s else "memory")
        if mesh_name == "card":
            rec["arguments_fit_card"] = arg_bytes <= CARD_BYTES
    except Exception as e:       # a cell's failure is its record's status
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _write(rec, out_dir, cell_id)
    return rec


def _write(rec: dict, out_dir, cell_id: str):
    if out_dir is None:
        return
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Shapes, per-chip bytes and roofline terms of every "
                    "cell on the meta device.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=MESHES + ("every",))
    ap.add_argument("--all", action="store_true",
                    help="every arch, shape and mesh")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    archs = all_arch_names() if args.all or args.arch is None \
        else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None \
        else [args.shape]
    meshes = MESHES if args.all or args.mesh == "every" else (args.mesh,)
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                rec = dryrun_cell(arch, shape, mesh, out_dir=args.out)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    extra = (f" args/chip="
                             f"{rec['argument_bytes_per_chip'] / 2**30:.3f} "
                             f"GiB bottleneck={rec['bottleneck']}")
                    if "arguments_fit_card" in rec:
                        extra += (f" arguments_fit_card="
                                  f"{rec['arguments_fit_card']}")
                elif status == "error":
                    failed += 1
                    extra = " " + rec["error"][:200]
                print(f"[dryrun] {arch}__{shape}__{MESH_NAMES[mesh]}: "
                      f"{status}{extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
