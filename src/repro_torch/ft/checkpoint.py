"""Checkpoint/restart: atomic, step-tagged (port of
``src/repro/ft/checkpoint.py``, the same layout, so a checkpoint that one
package writes restores in the other).

Layout:  <dir>/step_<k>/  { manifest.json, shard_<host>.npz }
- writes go to a tmp dir + os.replace (atomic on POSIX) so a crash
  mid-save never corrupts the latest checkpoint;
- leaves are flattened in ``jax.tree_util``'s order (``pytree``: sorted
  dict keys, tuple fields in order), leaf i stored as ``leaf_i``;
- the manifest stores each leaf's dtype and shape; bfloat16 (which numpy
  has no type for) is stored as its uint16 bit pattern under the dtype
  name ``bfloat16``, as the reference stores it;
- ``treedef`` is a description of the tree (the reference writes
  ``str(treedef)``); a restore checks the leaf count, shapes and dtypes
  against the structure it restores into, not that string;
- keep_last trims old steps after a successful save;
- mesh-portable: a sharded leaf (``distributed.sharding.ShardedTensor``)
  is gathered whole before it is written, so the files are the same
  whatever mesh saved them, and ``restore_checkpoint(shardings=)``
  places each leaf on any mesh (the elastic re-mesh path).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.sharding import gather, is_sharded, shard
from ..kernels.ops import resolve_device
from ..pytree import tree_leaves, tree_structure, tree_unflatten

def _encode(t: torch.Tensor):
    """(numpy array to store, logical dtype name) of one leaf: a dtype
    numpy has no type for (bfloat16, float8_*) as the unsigned integers
    of its width, holding its bits."""
    t = (gather(t, "cpu") if is_sharded(t) else t).detach().to("cpu")
    name = str(t.dtype).split(".")[-1]
    try:
        return t.numpy(), name
    except TypeError:
        bits = 8 * t.element_size()
        return t.view(getattr(torch, f"int{bits}")).numpy().view(
            f"u{bits // 8}"), name


def _decode(raw: np.ndarray, dtype_name: str) -> torch.Tensor:
    if raw.dtype.name != dtype_name:       # the bits of a non-numpy dtype
        return torch.from_numpy(raw.view(f"i{raw.dtype.itemsize}")).view(
            getattr(torch, dtype_name))
    return torch.from_numpy(np.array(raw))


def save_checkpoint(ckpt_dir, step: int, tree: Any, *, keep_last: int = 3,
                    host_index: int = 0) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree, is_sharded)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_"))
    try:
        encoded = [_encode(x) for x in leaves]
        arrays = {f"leaf_{i}": e[0] for i, e in enumerate(encoded)}
        np.savez(tmp / f"shard_{host_index}.npz", **arrays)
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "treedef": tree_structure(tree, is_sharded),
            "leaves": [{"dtype": e[1], "shape": list(e[0].shape)}
                       for e in encoded],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                 # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _trim(ckpt_dir, keep_last)
    return final


def _trim(ckpt_dir: Path, keep_last: int):
    steps = sorted(p for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_"))
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, tree_like: Any, *, step: Optional[int]
                       = None, shardings: Any = None, host_index: int = 0,
                       device=None) -> Any:
    """Restore into the structure of ``tree_like`` (tensors, ``meta``
    ones included, or sharded tensors, whose global shapes and dtypes
    each stored leaf must have).  With ``shardings`` (a matching tree of
    ``Placement`` s) each leaf is placed on its mesh, which is what makes
    checkpoints mesh-portable; every other leaf (all of them without
    ``shardings``, a ``None`` placement with them) goes to ``device``
    (the card unless ``"cpu"``)."""
    ckpt_dir = Path(ckpt_dir)
    places = None if shardings is None else tree_leaves(shardings)
    if places is None or None in places:
        device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    like = tree_leaves(tree_like, is_sharded)
    if manifest["num_leaves"] != len(like) or (
            places is not None and len(places) != len(like)):
        raise ValueError(f"{d}: {manifest['num_leaves']} leaves, the tree "
                         f"to restore into has {len(like)}")
    leaves = []
    with np.load(d / f"shard_{host_index}.npz") as data:
        for i, want in enumerate(like):
            leaf = _decode(data[f"leaf_{i}"], manifest["leaves"][i]["dtype"])
            if leaf.shape != want.shape or leaf.dtype != want.dtype:
                raise ValueError(
                    f"{d}: leaf {i} is {leaf.dtype}{list(leaf.shape)}, the "
                    f"tree wants {want.dtype}{list(want.shape)}")
            leaves.append(leaf.to(device) if places is None
                          or places[i] is None else shard(leaf, places[i]))
    return tree_unflatten(tree_like, leaves, is_sharded)
