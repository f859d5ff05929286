"""Meshes and placements (port of ``src/repro/distributed/sharding.py``
and of ``chip_mesh`` / ``resolve_chip_mesh`` in
``src/repro/core/spmm.py``).

Two meshes live here, both single-controller: one process drives every
chip, and a chip is a torch device, which may repeat, so four chips can
share ``cuda:0`` or the CPU (the counterpart of the reference's
``--xla_force_host_platform_device_count`` virtual devices), or lie on
four cards, where what moves between chips crosses NVLink as copies on
streams of their own (:func:`card_copy`; :func:`spread` lays chips out
over cards).

* :class:`ChipMesh` is the sharded fused path's 1-D ``("chips",)`` mesh
  (K8).  :func:`place_on_chips` is the counterpart of
  ``chip_row_sharding`` + ``jax.device_put``: row ``c`` of a stacked
  ``(C, ...)`` array goes to chip ``c``'s device.  :func:`run_on_chips`
  is the chip loop of the three sharded wrappers: one kernel launch per
  chip, on its device, with its own staged window.
* :class:`LogicalMesh` is the model stacks' n-D ``("data", "model")`` or
  ``("pod", "data", "model")`` mesh.  The reference's logical-axis rules
  (``AxisEnv``, ``resolve_spec``, ``_PARAM_RULES``, ``_CACHE_RULES``)
  are copied as pure logic; a ``PartitionSpec`` is a tuple whose entries
  are ``None``, an axis name or a tuple of axis names.  A
  :class:`Placement` (``NamedSharding``) pairs a mesh with a spec, and a
  :class:`ShardedTensor` holds one block per distinct shard of a global
  tensor, stored once on the device of the first chip that holds it
  (so four chips on one card hold one copy of a replicated leaf), plus
  the chip -> block map.  It is a pytree node whose leaves are its
  blocks, so ``AdamW.init``/``update`` and ``tree_map`` run over blocks
  unchanged.  :func:`shard` places a whole tensor, :func:`gather`
  assembles it on one device from its blocks (the all-gather) with
  differentiable ops, so gradients land on the blocks.

The model axis splits compute as GSPMD's Megatron split does
(``distributed/model_split.py``): the chip at model coordinate ``m``
computes with its own block of every leaf the rules split over ``tp``.
:func:`model_dim` names the dim a placement splits over ``model``,
:func:`owned_range` the global range of each dim the chips at model
coordinate ``m`` hold, and :func:`gather_slice` assembles any part of
a global tensor from the blocks that hold it: over :func:`owned_range`,
a model coordinate's own part, gathered over the data axis only.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pytree import register_node, tree_leaves, tree_map, tree_map_with_path


def _normalise(device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a chip is the CPU or a CUDA device, got {dev}")
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.index is None:
        index = (torch.cuda.current_device()
                 if torch.cuda.is_available() else 0)
        return torch.device("cuda", index)
    return dev


@dataclasses.dataclass(frozen=True)
class ChipMesh:
    """A 1-D mesh of chips: ``devices[c]`` runs chip ``c``'s launch.

    Every device has the same type (all ``cuda:*`` or all ``cpu``); a
    device may repeat, so one card or one CPU hosts several chips.
    Hashable, so it can stand in a cache key's place as the reference's
    ``Mesh`` does (the key itself holds :func:`mesh_fingerprint`)."""
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(_normalise(d) for d in self.devices)
        if not devs:
            raise ValueError("a chip mesh needs at least one device")
        types = {d.type for d in devs}
        if len(types) != 1:
            raise ValueError(f"a chip mesh mixes device types: "
                             f"{sorted(types)}")
        object.__setattr__(self, "devices", devs)

    @property
    def axis_names(self) -> Tuple[str]:
        return ("chips",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    @property
    def single_device(self) -> bool:
        """Every chip on one device, so all chips share one memory."""
        return len(set(self.devices)) == 1


def chip_mesh(n_chips: int, device=None) -> ChipMesh:
    """1-D ``("chips",)`` mesh of ``n_chips`` chips: the first
    ``n_chips`` CUDA cards (raising when fewer exist, as the reference
    raises for too few devices), or with ``device="cpu"`` ``n_chips``
    CPU chips — the reference's virtual host devices."""
    if device is not None and torch.device(device).type == "cpu":
        if n_chips < 1:
            raise ValueError(f"n_chips must be >= 1, got {n_chips}")
        return ChipMesh((torch.device("cpu"),) * n_chips)
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"device must be 'cpu' or a CUDA device, got "
                         f"{device!r}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 1 <= n_chips <= count:
        raise ValueError(f"n_chips={n_chips} but {count} device(s) "
                         f"available")
    return ChipMesh(tuple(torch.device("cuda", i) for i in range(n_chips)))


def resolve_chip_mesh(mesh: Optional[ChipMesh], n_chips: Optional[int],
                      device=None) -> Optional[ChipMesh]:
    """Normalise the two spellings of "shard over C chips" to one
    :class:`ChipMesh` (or None = unsharded), so cache keys and artifacts
    agree whichever the caller used; ``n_chips`` alone builds
    :func:`chip_mesh` on ``device``'s type."""
    if mesh is None and n_chips is None:
        return None
    if mesh is not None:
        if not isinstance(mesh, ChipMesh):
            raise TypeError(f"mesh must be a ChipMesh, got "
                            f"{type(mesh).__name__}")
        if n_chips is not None and n_chips != mesh.size:
            raise ValueError(f"n_chips={n_chips} != mesh size {mesh.size}")
        return mesh
    return chip_mesh(n_chips, device)


def place_on_chips(stacked, mesh: ChipMesh) -> Tuple[torch.Tensor, ...]:
    """Chip ``c``'s row of ``stacked`` on ``mesh.devices[c]``.

    ``stacked`` is a ``(C, ...)`` tensor or a sequence of C per-chip
    tensors.  Each row comes back contiguous; on a CUDA chip a row that
    would start off a 16-byte boundary (a view into a stacked tensor
    already on that device) is copied, because the staged kernels copy
    their streams in 16-byte units."""
    if len(stacked) != mesh.size:
        raise ValueError(f"{len(stacked)} chip rows for a mesh of "
                         f"{mesh.size} chips")
    return tuple(aligned16(row.to(dev).contiguous())
                 for row, dev in zip(stacked, mesh.devices))


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it lies on the CPU or starts on a 16-byte
    boundary, else a contiguous copy (which the allocator places on
    one).  The kernels that copy an operand in 16-byte units take it
    through here, so a valid view that starts elsewhere is computed, not
    refused."""
    if t.device.type == "cpu" or t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def check_on_mesh(mesh: ChipMesh, **operands) -> None:
    """Every operand tensor (or per-chip sequence of tensors) lies on a
    device of the mesh's type: a CUDA mesh never takes CPU operands,
    and a CPU mesh never takes CUDA ones — there is no fallback."""
    for name, value in operands.items():
        if value is None:
            continue
        parts: Sequence = (value,) if isinstance(value, torch.Tensor) \
            else value
        for t in parts:
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"{name} must be a tensor or a sequence "
                                f"of per-chip tensors")
            if t.device.type != mesh.device_type:
                raise ValueError(f"{name} is on {t.device}, the mesh on "
                                 f"{mesh.device_type}")


def chip_windows(v, n_chips: int) -> tuple:
    """Normalise a staged window argument to a per-chip tuple: an int
    (the uniform spelling) broadcasts; a sequence — tuple, list or
    array, e.g. ``ShardedFusedWorkspace.chip_span`` — passes through."""
    if hasattr(v, "__len__"):
        if len(v) != n_chips:
            raise ValueError(f"per-chip staging windows need one entry per "
                             f"chip: got {len(v)} for {n_chips} chips")
        return tuple(int(s) for s in v)
    return (int(v),) * n_chips


def run_on_chips(kernel, stacked, per_chip, *, mesh: ChipMesh, staging: str,
                 span, cspan, cap, knobs: dict,
                 counter=None) -> torch.Tensor:
    """Call ``kernel`` once per chip and stack the results, in chip
    order, on the first chip's device: ``(C, B*bm, d_pad)``.

    ``stacked`` are the (C, ...) descriptor tables and streams (stacked
    tensors or per-chip sequences), moved row by row to their chips;
    ``per_chip[c]`` are chip ``c``'s trailing operands, already on its
    device.  A staged launch takes its OWN chip's window — the port's
    form of the reference's per-window ``lax.switch`` — and ``cap``.
    ``counter`` (a sharded wrapper) gains the launches the calls made."""
    if staging not in ("resident", "dma"):
        raise ValueError(f"staging must be 'resident' or 'dma', got "
                         f"{staging!r}")
    spans = chip_windows(span, mesh.size)
    cspans = chip_windows(cspan, mesh.size)
    chips = [place_on_chips(t, mesh) for t in stacked]
    outs = []
    for c in range(mesh.size):
        kw = dict(knobs)
        if staging == "dma":
            kw.update(span=spans[c], cspan=cspans[c], cap=cap)
        before = kernel.launches if counter is not None else 0
        outs.append(kernel(*(t[c] for t in chips), *per_chip[c], **kw))
        if counter is not None:
            counter.launches += kernel.launches - before
    return torch.stack([y.to(mesh.devices[0]) for y in outs])


# ---------------------------------------------------------------------------
# The model stacks' n-D mesh and the logical-axis rules
# ---------------------------------------------------------------------------

def _mesh_device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.type == "meta" else _normalise(dev)


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    """An n-D mesh of chips: ``axis_names`` (``("data", "model")`` or
    ``("pod", "data", "model")``), their sizes ``shape``, and
    ``devices[c]`` the torch device of the chip at flat (row-major)
    coordinate ``c``.  A device may repeat; ``meta`` chips hold shapes
    only (the dry run's production meshes)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        shape = tuple(int(n) for n in self.shape)
        devs = tuple(_mesh_device(d) for d in self.devices)
        if len(self.axis_names) != len(shape) or min(shape, default=0) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and shape {shape} "
                             f"do not match")
        if len(devs) != math.prod(shape):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"devices, got {len(devs)}")
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "devices", devs)

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def single_device(self) -> bool:
        """Every chip on one device, so all chips share one memory."""
        return len(set(self.devices)) == 1

    def coords(self, chip: int) -> Dict[str, int]:
        """Chip ``chip``'s coordinate on each axis."""
        return dict(zip(self.axis_names,
                        (int(i) for i in np.unravel_index(chip, self.shape))))


def spread(devices: Sequence, n_chips: int) -> Tuple[torch.device, ...]:
    """Each of ``n_chips`` chips' device, the chips laid out row-major
    over ``devices``: every device takes a contiguous run of ``n_chips /
    len(devices)`` chips (four chips over ``cuda:0..3``: one a card; over
    ``cuda:0..1``: a (2, 2) mesh's data groups one a card, each group's
    model chips sharing it).  Raises where the devices do not divide the
    chips."""
    devs = tuple(_mesh_device(d) for d in devices)
    if not devs or n_chips < 1 or n_chips % len(devs):
        raise ValueError(f"{len(devs)} device(s) do not divide {n_chips} "
                         f"chips into equal runs")
    run = n_chips // len(devs)
    return tuple(devs[c // run] for c in range(n_chips))


def synchronize(devices) -> None:
    """Wait for every CUDA device among ``devices`` (each once)."""
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def written(devices) -> Dict[torch.device, Any]:
    """An event on each CUDA card of ``devices``, recorded on its current
    stream now: a tensor on that card written before this call is ready
    once its card's event is (what :func:`card_copy` waits for)."""
    out = {}
    for dev in dict.fromkeys(_normalise(d) for d in devices):
        if dev.type == "cuda":
            out[dev] = torch.cuda.Event()
            out[dev].record(torch.cuda.current_stream(dev))
    return out


_COPY_STREAMS: Dict[Tuple[torch.device, torch.device], Any] = {}


def _copy_stream(src: torch.device, dst: torch.device):
    """The copy stream of ``src`` that carries its copies to ``dst`` (one
    a pair of cards, so a copy waits behind no other pair's)."""
    key = (src, dst)
    if key not in _COPY_STREAMS:
        _COPY_STREAMS[key] = torch.cuda.Stream(device=src)
    return _COPY_STREAMS[key]


def _side_copy(t: torch.Tensor, device: torch.device, ready=None):
    """``t`` copied to ``device``.  Between CUDA cards the copy runs on the
    source card's copy stream for the pair, which waits for ``ready`` (an
    event after ``t`` was written; None: recorded now on the source's
    current stream) and for the destination's current stream, where the
    copy is allocated; that stream then waits for the copy (PyTorch's
    barrier of a copy between cards, on our stream in the source's
    place), and the allocator learns that the copy stream read ``t``."""
    if not (t.is_cuda and device.type == "cuda"):
        return t.to(device, copy=True)
    stream = _copy_stream(t.device, device)
    if ready is None:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        out = t.to(device)
    t.record_stream(stream)
    return out


class _CardCopy(torch.autograd.Function):
    """A differentiable copy between devices whose backward copies the
    gradient back the same way (:func:`_side_copy`, ``ready`` now)."""

    @staticmethod
    def forward(ctx, t, device, ready):
        ctx.source = t.device
        return _side_copy(t, device, ready)

    @staticmethod
    def backward(ctx, grad):
        return _side_copy(grad, ctx.source), None, None


def card_copy(t: torch.Tensor, device, ready=None) -> torch.Tensor:
    """``t`` on ``device``: itself where it lies there; from one CUDA card
    to another a copy on a stream of its own (:func:`_side_copy`: it
    waits for ``ready``, or for ``t``'s producer, not behind the source
    card's whole queue), whose gradient goes back on a stream of its own
    too; otherwise ``t.to(device)``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = _normalise(device)
    if t.device == device:
        return t
    if t.is_cuda and device.type == "cuda":
        return _CardCopy.apply(t, device, ready)
    return t.to(device)


def logical_mesh(shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence) -> LogicalMesh:
    """A mesh over the first ``prod(shape)`` of ``devices``."""
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, "
                         f"{len(devices)} given")
    return LogicalMesh(tuple(axis_names), tuple(shape), tuple(devices[:n]))


class AxisEnv:
    """The logical axes on a mesh: ``dp``/``sp`` -> the batch axes
    (``("pod", "data")`` on a multi-pod mesh), ``fsdp`` -> ``data``,
    ``tp`` -> ``model``."""

    def __init__(self, mesh: LogicalMesh):
        self.mesh = mesh
        self.multi_pod = "pod" in mesh.axis_names
        self.sizes = dict(zip(mesh.axis_names, mesh.shape))

    def logical(self, name: str) -> Tuple[str, ...]:
        if name in ("dp", "sp"):
            return ("pod", "data") if self.multi_pod else ("data",)
        if name == "fsdp":
            return ("data",)
        if name == "tp":
            return ("model",)
        raise KeyError(name)

    def axis_prod(self, axes: Sequence[str]) -> int:
        return math.prod(self.sizes[a] for a in axes)


Spec = Tuple[Any, ...]       # entries: None, an axis name, a tuple of names


def resolve_spec(shape: Sequence[int], dim_rules: Dict[int, List[str]],
                 env: AxisEnv) -> Spec:
    """First candidate per dim that divides and doesn't reuse an axis."""
    used: set = set()
    spec: List = [None] * len(shape)
    for dim in sorted(dim_rules):
        if dim >= len(shape):
            continue
        for cand in dim_rules[dim]:
            axes = env.logical(cand)
            if any(a in used for a in axes):
                continue
            if shape[dim] > 0 and shape[dim] % env.axis_prod(axes) == 0:
                spec[dim] = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
    return tuple(spec)


# Parameter rules: (path-suffix regex, dim -> logical-axis candidates).
# Dims are indexed on the UNSTACKED shape; period-stacked leaves get +1.
# First match wins.
_PARAM_RULES: List[Tuple[str, Dict[int, List[str]]]] = [
    (r"\bembed$",                {0: ["tp"], 1: ["fsdp"]}),
    (r"\blm_head$",              {1: ["tp"], 0: ["fsdp"]}),
    (r"\bfinal_norm$",           {}),
    # attention
    (r"\bw[qkv]$",               {1: ["tp"], 0: ["fsdp"]}),
    (r"\bwo$",                   {0: ["tp"], 2: ["fsdp"]}),
    (r"\bb[qkv]$",               {0: ["tp"]}),
    (r"\b[qk]_norm$",            {}),
    (r"\bgate$",                 {}),
    # MoE (E first -> EP when divisible; else F -> TP)
    (r"\brouter$",               {}),
    (r"ffn_moe.*\bw_(gate|up)$", {0: ["tp"], 2: ["tp"], 1: ["fsdp"]}),
    (r"ffn_moe.*\bw_down$",      {0: ["tp"], 1: ["tp"], 2: ["fsdp"]}),
    # dense FFN
    (r"\bw_(gate|up)$",          {1: ["tp"], 0: ["fsdp"]}),
    (r"\bw_down$",               {0: ["tp"], 1: ["fsdp"]}),
    # mamba
    (r"\bin_proj$",              {1: ["tp"], 0: ["fsdp"]}),
    (r"\bconv_w$",               {1: ["tp"]}),
    (r"\b(conv_b|dt_bias|D)$",   {0: ["tp"]}),
    (r"\bx_proj$",               {0: ["tp"]}),
    (r"\bdt_proj$",              {1: ["tp"]}),
    (r"\bA_log$",                {0: ["tp"]}),
    (r"\bout_proj$",             {0: ["tp"], 1: ["fsdp"]}),
    # rwkv time-mix / channel-mix
    (r"tm.*\bw_[rkvg]$",         {1: ["tp"], 0: ["fsdp"]}),
    (r"tm.*\bw_o$",              {0: ["tp"], 2: ["fsdp"]}),
    (r"tm.*\b(u|w0|gn_w|gn_b)$", {0: ["tp"]}),
    (r"lora_\w+_a$",             {0: ["fsdp"]}),
    (r"lora_\w+_b$",             {1: ["fsdp"]}),
    (r"\bmu_\w+$",               {}),
    (r"cm.*\bw_k$",              {1: ["tp"], 0: ["fsdp"]}),
    (r"cm.*\bw_v$",              {0: ["tp"], 1: ["fsdp"]}),
    (r"cm.*\bw_r$",              {1: ["tp"], 0: ["fsdp"]}),
    # norms and anything else small
    (r"\bln(_w|_b|_kv)?$",       {}),
]


def _path_str(path) -> str:
    """The reference's path string: ``pytree.tree_map_with_path`` keys
    are already ``jax.tree_util``'s key strings (a dict key, a sequence
    index, ``.field`` of a NamedTuple)."""
    return "/".join(str(k) for k in path)


def param_pspec(path, shape, env: AxisEnv) -> Spec:
    ps = _path_str(path)
    stacked = "period" in ps
    for pattern, rules in _PARAM_RULES:
        if re.search(pattern, ps):
            if stacked:
                rules = {d + 1: c for d, c in rules.items()}
            rules = {d: c for d, c in rules.items() if d < len(shape)}
            return resolve_spec(shape, rules, env)
    return ()   # replicate unknown leaves


_CACHE_RULES: List[Tuple[str, Dict[int, List[str]]]] = [
    # attn cache (P,B,T,KV,hd): batch -> dp; else sequence -> sp (flash-
    # decoding style); kv heads -> tp when divisible
    (r"\bk(pos)?$|\bv$",   {1: ["dp"], 2: ["sp"], 3: ["tp"]}),
    (r"\bx[kv]$",          {1: ["dp"], 3: ["tp"]}),
    (r"\bssm$",            {1: ["dp"], 2: ["tp"]}),
    (r"\bconv$",           {1: ["dp"], 3: ["tp"]}),
    (r"\bwkv$",            {1: ["dp"], 2: ["tp"]}),
    (r"\bx_prev_\w+$",     {1: ["dp"]}),
]


def cache_pspec(path, shape, env: AxisEnv) -> Spec:
    ps = _path_str(path)
    for pattern, rules in _CACHE_RULES:
        if re.search(pattern, ps):
            return resolve_spec(shape, rules, env)
    return ()


# ---------------------------------------------------------------------------
# Placements (NamedSharding) and the sharded tensor
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and a spec: dim ``d`` of a tensor splits over the axes
    ``spec[d]`` (row-major over them, as GSPMD splits it), dims past the
    spec's end and ``None`` entries are whole, and every chip whose
    coordinates agree on those axes holds the same shard."""
    mesh: LogicalMesh
    spec: Spec = ()

    def grid(self, ndim: int) -> Tuple[int, ...]:
        """Shards along each of ``ndim`` dims."""
        sizes = self.mesh.sizes
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(sizes[a] for a in _axes(e)) for e in spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one shard of a ``shape`` tensor."""
        grid = self.grid(len(shape))
        for n, g in zip(shape, grid):
            if n % g:
                raise ValueError(f"dim {n} does not split into {g} shards "
                                 f"under {self.spec}")
        return tuple(n // g for n, g in zip(shape, grid))

    def chip_block(self, ndim: int) -> Tuple[int, ...]:
        """For every chip, the index of its shard in the row-major shard
        grid."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        grid, sizes = self.grid(ndim), self.mesh.sizes
        out = []
        for chip in range(self.mesh.size):
            at = self.mesh.coords(chip)
            index = []
            for e in spec:
                i = 0
                for a in _axes(e):
                    i = i * sizes[a] + at[a]
                index.append(i)
            out.append(int(np.ravel_multi_index(index, grid)) if grid else 0)
        return tuple(out)

    def block_devices(self, ndim: int) -> Tuple[torch.device, ...]:
        """Each block's storage device: the first chip's that holds it."""
        grid = self.grid(ndim)
        owner: Dict[int, torch.device] = {}
        for chip, b in enumerate(self.chip_block(ndim)):
            owner.setdefault(b, self.mesh.devices[chip])
        return tuple(owner[b] for b in range(math.prod(grid)))


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A global tensor of ``shape`` under ``placement``: ``blocks[b]`` is
    shard ``b`` of the row-major shard grid, once, on its owner chip's
    device (:meth:`Placement.block_devices`)."""
    placement: Placement
    shape: torch.Size
    blocks: Tuple[torch.Tensor, ...]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def period(self, index: int) -> "ShardedTensor":
        """Index ``index`` of the whole leading axis (a period-stacked
        leaf's period), as views of the blocks."""
        spec = self.placement.spec
        if spec and spec[0] is not None:
            raise ValueError(f"the leading axis is sharded ({spec})")
        return ShardedTensor(Placement(self.placement.mesh, tuple(spec[1:])),
                             self.shape[1:],
                             tuple(b[index] for b in self.blocks))

    def chip_bytes(self) -> List[int]:
        """Bytes of each chip's block."""
        sizes = [b.numel() * b.element_size() for b in self.blocks]
        return [sizes[b] for b in self.placement.chip_block(self.ndim)]


register_node(ShardedTensor, lambda t: list(t.blocks),
              lambda t, blocks: ShardedTensor(t.placement, t.shape,
                                              tuple(blocks)))


def shard(full: torch.Tensor, placement: Placement) -> ShardedTensor:
    """``full`` cut into its distinct shards, each copied once to its
    owner's device (contiguous, sharing no storage with ``full``)."""
    shape = tuple(full.shape)
    part = placement.shard_shape(shape)
    grid = placement.grid(len(shape))
    blocks = []
    for b, dev in enumerate(placement.block_devices(len(shape))):
        index = np.unravel_index(b, grid) if grid else ()
        piece = full[tuple(slice(i * n, (i + 1) * n)
                           for i, n in zip(index, part))]
        blocks.append(piece.detach().to(dev).clone(
            memory_format=torch.contiguous_format))
    return ShardedTensor(placement, full.shape, tuple(blocks))


def gather(sharded: ShardedTensor, device) -> torch.Tensor:
    """The global tensor on ``device``: the blocks moved there and
    concatenated dim by dim (``.to`` and ``torch.cat``, so autograd
    carries a gradient back onto each block).  A replicated tensor on
    its own device comes back as its one block, uncopied."""
    grid = sharded.placement.grid(sharded.ndim)
    blocks = [b.to(device) for b in sharded.blocks]

    def assemble(parts, dim):
        if dim == len(grid):
            return parts[0]
        n = grid[dim]
        step = len(parts) // n
        rows = [assemble(parts[i * step:(i + 1) * step], dim + 1)
                for i in range(n)]
        return rows[0] if n == 1 else torch.cat(rows, dim)

    return assemble(blocks, 0)


Range = Tuple[int, int]


def model_dim(placement: Placement, ndim: int) -> Optional[int]:
    """The dim that ``placement`` splits over the ``model`` axis alone,
    or None.  A dim split over ``model`` together with another axis
    raises: no rule makes one, and the compute split takes whole blocks
    of one dim."""
    spec = tuple(placement.spec)[:ndim]
    for d, e in enumerate(spec):
        axes = _axes(e)
        if "model" in axes:
            if len(axes) > 1:
                raise ValueError(f"dim {d} splits over {axes}: the model "
                                 f"axis computes whole blocks of one dim")
            return d
    return None


def owned_range(placement: Placement, shape: Sequence[int],
                model: int) -> Tuple[Range, ...]:
    """The global (start, stop) range of each dim of a ``shape`` tensor
    that the chips at model coordinate ``model`` hold between them: the
    ``model``-th block of the dim split over ``model``, every other dim
    whole."""
    shape = tuple(shape)
    d = model_dim(placement, len(shape))
    out = [(0, n) for n in shape]
    if d is not None:
        n = shape[d] // placement.mesh.sizes["model"]
        out[d] = (model * n, (model + 1) * n)
    return tuple(out)


def gather_slice(sharded: ShardedTensor, index: Sequence[Range],
                 device, ready: Optional[Dict] = None) -> torch.Tensor:
    """The part ``index`` (one (start, stop) range per dim) of the global
    tensor on ``device``: the blocks that hold it, cut to it, moved
    there and concatenated dim by dim, differentiably as :func:`gather`
    (a block read whole and already on ``device`` comes back
    uncopied).  A block on another card moves by :func:`card_copy`, on
    its card's copy stream for the pair, waiting only for its card's
    event in ``ready`` (``{card: event}`` from :func:`written`, recorded
    where the blocks were last written, e.g. a training step's start),
    so a data group reading another group's blocks does not queue behind
    that group's forward and backward; its gradient goes back the same
    way.  Without an event the copy waits for what the block's card has
    queued so far."""
    ready = ready or {}

    def move(block):
        return card_copy(block, device, ready.get(block.device))

    if sharded.ndim == 0:
        return move(sharded.blocks[0])
    grid = sharded.placement.grid(sharded.ndim)
    part = sharded.placement.shard_shape(tuple(sharded.shape))
    pieces = []
    for (lo, hi), n in zip(index, part):
        if not 0 <= lo < hi:
            raise ValueError(f"empty or negative range {(lo, hi)}")
        pieces.append([(i, max(lo, i * n) - i * n, min(hi, (i + 1) * n)
                        - i * n) for i in range(lo // n, (hi - 1) // n + 1)])

    def assemble(dim, at, cut):
        if dim == len(grid):
            block = sharded.blocks[int(np.ravel_multi_index(at, grid))]
            if any((a, b) != (0, n) for (a, b), n in zip(cut, part)):
                block = block[tuple(slice(a, b) for a, b in cut)]
            return move(block)
        rows = [assemble(dim + 1, at + (i,), cut + ((a, b),))
                for i, a, b in pieces[dim]]
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim)

    return assemble(0, (), ())


def is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


def shard_tree(tree, placements):
    """Every tensor of ``tree`` placed by the matching leaf of
    ``placements`` (a sharded leaf is gathered and placed anew)."""
    return tree_map(lambda x, p: shard(gather(x, x.blocks[0].device)
                                       if is_sharded(x) else x, p),
                    tree, placements, is_leaf=is_sharded)


def gather_tree(tree, device):
    """Every leaf of ``tree`` whole on ``device``."""
    return tree_map(lambda x: gather(x, device) if is_sharded(x)
                    else x.to(device), tree, is_leaf=is_sharded)


def chip_bytes(tree, mesh: LogicalMesh) -> List[int]:
    """Bytes resident on each chip: the sum of its blocks over the
    sharded leaves of ``tree`` (a plain tensor counts on every chip)."""
    total = [0] * mesh.size
    for x in tree_leaves(tree, is_leaf=is_sharded):
        per = x.chip_bytes() if is_sharded(x) else \
            [x.numel() * x.element_size()] * mesh.size
        total = [a + b for a, b in zip(total, per)]
    return total


def placed_bytes(shapes, placements) -> int:
    """Per-chip bytes of ``shapes`` (tensors, ``meta`` ones included)
    under ``placements``: the counterpart of a compiled step's
    ``argument_size_in_bytes`` (every chip holds one shard of each leaf,
    so each chip holds the same count)."""
    return sum(math.prod(p.shard_shape(tuple(x.shape))) * x.element_size()
               for x, p in zip(tree_leaves(shapes), tree_leaves(placements)))


def param_shardings(param_shapes, mesh: LogicalMesh, *, mode: str = "train"):
    """Tree of :class:`Placement` matching a tree of tensors (``meta`` ones
    included).

    mode="train": FSDP(data) x TP(model) per _PARAM_RULES.
    mode="serve_replicated": TP-only — drop the fsdp axis so weights are
    replicated across ``data`` (use when param_bytes/TP fits device
    memory; the classic weight-stationary serving layout)."""
    if mode not in ("train", "serve_replicated"):
        raise ValueError(f"mode must be 'train' or 'serve_replicated', got "
                         f"{mode!r}")
    env = AxisEnv(mesh)

    def leaf(path, x):
        spec = param_pspec(path, tuple(x.shape), env)
        if mode == "serve_replicated":
            spec = tuple(None if s in ("data", ("data",)) else s
                         for s in spec)
        return Placement(mesh, spec)
    return tree_map_with_path(leaf, param_shapes)


def batch_shardings(batch_shapes, mesh: LogicalMesh):
    """tokens/labels (B,S) B->dp; image_embeds (B,I,D) B->dp."""
    env = AxisEnv(mesh)
    return tree_map_with_path(
        lambda path, x: Placement(mesh, resolve_spec(tuple(x.shape),
                                                     {0: ["dp"]}, env)),
        batch_shapes)


def decode_shardings(decode_shapes, mesh: LogicalMesh):
    """{token, caches, pos} input tree for serve_step."""
    env = AxisEnv(mesh)

    def leaf(path, x):
        ps = _path_str(path)
        if ps.startswith("token"):
            return Placement(mesh, resolve_spec(tuple(x.shape), {0: ["dp"]},
                                                env))
        if ps.startswith("pos"):
            return Placement(mesh, ())
        return Placement(mesh, cache_pspec(path, tuple(x.shape), env))
    return tree_map_with_path(leaf, decode_shapes)


def logits_sharding(mesh: LogicalMesh, batch: int, vocab: int) -> Placement:
    """(B, S, V) logits: B->dp when divisible, V->tp when divisible."""
    env = AxisEnv(mesh)
    return Placement(mesh, resolve_spec((batch, 1, vocab),
                                        {0: ["dp"], 2: ["tp"]}, env))


def replicated(mesh: LogicalMesh) -> Placement:
    return Placement(mesh, ())


def chip_row_sharding(mesh) -> Placement:
    """Placement for the x-sharded fused SpMM operands (DESIGN.md §7.8):
    arrays stacked per chip on their leading axis shard over the 1-D chip
    mesh, so each chip holds only its own rows.  ``mesh`` is a
    :class:`ChipMesh` or a 1-D :class:`LogicalMesh`."""
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"x-sharded spmm uses a 1-D chip mesh, got {mesh.axis_names}")
    if isinstance(mesh, ChipMesh):
        mesh = LogicalMesh(("chips",), (mesh.size,), mesh.devices)
    return Placement(mesh, (mesh.axis_names[0],))
