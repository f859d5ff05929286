"""The chip mesh of the sharded fused path (port of the chip-mesh part of
``src/repro/distributed/sharding.py`` and of ``chip_mesh`` /
``resolve_chip_mesh`` in ``src/repro/core/spmm.py``).

The reference drives a 1-D ``("chips",)`` ``jax.sharding.Mesh`` from ONE
process under ``shard_map``.  The port keeps that single-controller
shape: a :class:`ChipMesh` is an explicit list of torch devices, and the
sharded wrappers loop over it, launching each chip's kernel on its own
device.  A device may repeat — ``ChipMesh(("cuda:0",) * 4)`` runs four
chips on one card, ``chip_mesh(4, device="cpu")`` four on the CPU — the
counterpart of the reference's ``--xla_force_host_platform_device_count``
virtual devices.

:func:`place_on_chips` is the counterpart of ``chip_row_sharding`` +
``jax.device_put``: row ``c`` of a stacked ``(C, ...)`` array goes to
chip ``c``'s device.  :func:`run_on_chips` is the chip loop of the three
sharded wrappers (K8): one kernel launch per chip, on its device, with
its own staged window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


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
