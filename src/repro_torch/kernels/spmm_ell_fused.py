"""K1 and K3: the fused multi-segment CCM SpMM — the whole plan in ONE
launch, resident (K1) or staged through shared memory (K3).

Replaces the TPU kernel ``src/repro/kernels/spmm_ell_fused.py`` ::
``spmm_ell_fused`` (``_kernel``, resident staging) with the hand-written
CUDA kernel ``csrc/spmm_ell_fused.cu``.  The planner packs every ELL
segment into one flat slot stream with a per-row-block descriptor table
(``blk_off``, ``blk_L``); one launch walks it and writes workspace rows
that the caller maps back to output order with one ``inv_perm`` gather.

What bounds it on an H100: bytes.  Each slot gathers a whole X row, and
for a large X most of those rows miss the 50 MB L2, so the floor is
about ``S * d_pad * 4`` bytes over 3.35 TB/s.  K1 takes one of two
routes by the width, :func:`ring_route`, both hand-written, chosen
before the launch:

- planned widths (``d_pad`` a multiple of 128, every width
  ``compile_spmm`` plans): the warp-specialised gather ring of K2/K3/K4
  (``csrc/spmm_gather_ring.cuh``) with K1's own descriptor source,
  stages of :func:`resident_geometry`'s ``rows`` (at least
  :data:`STAGE_ROWS`) X row segments and their values, copied by a
  producer warp ahead of four consumer warps; X passes through
  ``aligned16`` for the 16-byte copies;
- any other width (a direct call): one thread per output column, so a
  gathered row is one coalesced read per CTA, in CTAs of
  :func:`narrow_threads` threads (whole warps of the width up to 256
  columns, one CTA a trip).

Both keep a descriptor's ``bm`` row accumulators in registers, add the
slots in order with one rounding for the product and one for the sum,
and write each output row once, so their results are equal bit for bit
(the note in the ``.cu`` file has more).

:func:`spmm_ell_fused_plain` is the plain PyTorch version: it walks the
same descriptor stream in the same per-row order, vectorised over the
descriptors, rows and columns of each trip step.  The wrapper runs it
for CPU tensors; for CUDA tensors it launches the kernel or raises.

K3, :func:`spmm_ell_fused_staged`, replaces the TPU kernel
``spmm_ell_fused_staged`` (``_staged_kernel``, ``staging="dma"``) with
``csrc/spmm_ell_fused_staged.cu`` on ``csrc/spmm_gather_ring.cuh``:
persistent warp-specialised CTAs walk merged trips.  A producer warp
fills a ring of :data:`RING_SLOTS` shared-memory slots with each trip's
slot and column windows (bulk asynchronous copies) and gathers every
step's ``bm`` X-row segments into an :data:`X_STAGES`-stage X ring, up
to ``X_STAGES - 1`` steps ahead; four consumer warps add the steps in
K1's order.  Every slot and stage changes hands on a full and an empty
mbarrier, so no step waits for the whole CTA.  It is bound by the same
bytes as K1; the ring keeps the X-row gathers in flight whatever the
consumers do.  A window larger than the ring's slot (a hub row) is
walked in chunks that keep every row's order of summation, so K3 is
bit-identical to K1.  :func:`staging_geometry` and :func:`staged_walk`
hold the window arithmetic both staged kernels share, and
:func:`spmm_ell_fused_staged_plain` runs it on the CPU: it copies the
same aligned windows and chunks into buffers whose unfilled entries are
NaN (values) or out of range (columns), so a window error shows there.
The X ring is a device detail the plain version has no need of.

K8 for this backend, :func:`spmm_ell_fused_sharded`, replaces the
reference's ``spmm_ell_fused_sharded`` (``shard_map`` over a chip mesh,
one ``pallas_call`` per chip, the exact-panel exchange first under
``x_sharding="rows"``).  It has no device code of its own: the port is
single-controller, so it loops over a ``ChipMesh`` and launches K1 or K3
once per chip on that chip's device, each staged launch with its OWN
chip's window (the reference's per-window ``lax.switch``).  The chip
loop and the X placement the three sharded wrappers share are
``distributed.run_on_chips`` and ``distributed.sharded_x``;
:func:`spmm_ell_fused_sharded_plain` runs the same loop through the plain
versions.
"""
from __future__ import annotations

import ctypes

import torch

from ..distributed import aligned16, check_on_mesh, run_on_chips, sharded_x
from . import _build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_STAGED_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])

SUPPORTED_BM = (1, 2, 4, 8, 16)
# a stage of K1's and K10's gather rings holds at least this many X rows
# where its steps allow (csrc/spmm_gather_ring.cuh, kStageRows)
STAGE_ROWS = 8


def ring_route(d_pad: int) -> bool:
    """Whether K1 runs the gather ring at width ``d_pad``: whole
    128-column tiles, as every planned width is; any other width runs
    the one-thread-a-column body."""
    return d_pad > 0 and d_pad % COL_TILE == 0


# the widest CTA of K1's one-thread-a-column body
# (csrc/spmm_ell_fused.cu, kNarrowThreads)
NARROW_MAX_THREADS = 256


def narrow_threads(d_pad: int) -> int:
    """Threads a CTA of K1's one-thread-a-column body (its route at
    unplanned widths) takes, one a column: whole warps covering the
    width up to :data:`NARROW_MAX_THREADS` columns (one CTA a trip),
    else a 128-column tile."""
    if d_pad <= NARROW_MAX_THREADS:
        return -(-d_pad // 32) * 32
    return COL_TILE


def resident_geometry(*, bm: int) -> dict:
    """K1's ring stage: ``rows`` X row segments (at least
    :data:`STAGE_ROWS`), ``steps = rows // bm`` consecutive steps of
    one descriptor."""
    rows = max(STAGE_ROWS, bm)
    return dict(rows=rows, steps=rows // bm)


def resident_ring_bytes(*, bm: int) -> int:
    """Dynamic shared memory of one K1 ring CTA: a full and an empty
    mbarrier for each of the :data:`RING_SLOTS` slots (unused) and
    :data:`X_STAGES` stages, and the stages, each ``rows`` X row
    segments of one column tile and their ``rows`` values rounded up to
    whole 16-byte units (``csrc/spmm_gather_ring.cuh::ell_ring_bytes``
    computes the same)."""
    rows = resident_geometry(bm=bm)["rows"]
    barriers = 2 * (RING_SLOTS + X_STAGES) * MBARRIER_BYTES
    return barriers + X_STAGES * (rows * COL_TILE + -(-rows // 4) * 4) * 4


def check_tables(tables, cols_flat, vals_flat, x, *, bm: int, mw: int):
    """Validate the operands a fused kernel reads, before any pointer is
    taken: one device, int32 1-D descriptor tables of one length, an
    int32 column stream, f32 slot values, a 2-D f32 X, all contiguous,
    and a descriptor count the merge width divides."""
    for name, t in [*tables.items(), ("cols_flat", cols_flat)]:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} with shape {tuple(t.shape)}")
    if vals_flat.dtype != torch.float32 or vals_flat.dim() != 1:
        raise ValueError("vals_flat must be a 1-D float32 tensor")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("x must be a 2-D float32 tensor")
    check_placement({**tables, "cols_flat": cols_flat,
                     "vals_flat": vals_flat}, x)
    sizes = {t.shape[0] for t in tables.values()}
    if len(sizes) != 1:
        raise ValueError(f"descriptor tables differ in length: {sizes}")
    if bm not in SUPPORTED_BM:
        raise ValueError(f"bm must be one of {SUPPORTED_BM}, got {bm}")
    if mw < 1 or sizes.pop() % mw:
        raise ValueError(f"the merge width {mw} must divide the "
                         f"descriptor count")


def check_placement(operands, x) -> None:
    """Every operand in ``operands`` and ``x`` on x's device, the CPU or
    a CUDA device, and contiguous — what a kernel's raw pointers need."""
    for name, t in {**operands, "x": x}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors must be on the CPU or a CUDA device, "
                         f"got {x.device}")


def vpu_trips(acc, sel, off, coff, L, cols_flat, vals_flat, x, *, bm: int):
    """Run the gather-FMA trips of the descriptors ``sel`` into ``acc``
    (B, bm, d_pad), step by step: at step ``nz`` every descriptor with
    ``L > nz`` adds ``vals[off + r*L + nz] * x[cols[coff + r*L + nz]]``
    to row ``r`` — the kernels' per-row order, with one rounding for the
    product and one for the sum."""
    if sel.numel() == 0:
        return
    rr = torch.arange(bm, device=x.device)
    for nz in range(int(L[sel].max())):
        b = sel[L[sel] > nz]
        step = rr[None, :] * L[b, None] + nz                 # (nb, bm)
        v = vals_flat[off[b, None] + step]
        k = cols_flat[coff[b, None] + step].long()
        acc[b] = acc[b] + v[..., None] * x[k]


def _long(*tables):
    return [t.long() for t in tables]


def spmm_ell_fused_plain(blk_off, blk_L, cols_flat, vals_flat, x, *,
                         bm: int = 8, mw: int = 1) -> torch.Tensor:
    """Plain PyTorch K1: (B*bm, d_pad) workspace rows.  ``mw`` only
    groups descriptors into launches; each row's result does not depend
    on it, so the plain version accepts it and ignores it."""
    del mw
    off, L = _long(blk_off, blk_L)
    acc = torch.zeros((off.shape[0], bm, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    vpu_trips(acc, torch.arange(off.shape[0], device=x.device), off, off, L,
              cols_flat, vals_flat, x, bm=bm)
    return acc.reshape(-1, x.shape[1])


def spmm_ell_fused(blk_off, blk_L, cols_flat, vals_flat, x, *,
                   bm: int = 8, mw: int = 1) -> torch.Tensor:
    """Compute ALL plan segments: Y_ws (B*bm, d_pad) = plan · X.

    blk_off   : (B,) int32 — first slot of each row-block (descriptor)
    blk_L     : (B,) int32 — padded nnz/row of each row-block
    cols_flat : (S,) int32 — slot -> X row
    vals_flat : (S,) float32 — slot values, zero on padding slots
    x         : (n, d_pad) float32
    mw        : CGCM merge width — descriptors per CTA; divides B

    CPU tensors run :func:`spmm_ell_fused_plain`; CUDA tensors launch
    ``csrc/spmm_ell_fused.cu`` once (counted in ``spmm_ell_fused.launches``):
    the gather ring where :func:`ring_route` says so, with X through
    ``aligned16``, else the one-thread-a-column body in CTAs of
    :func:`narrow_threads` threads.
    """
    check_tables({"blk_off": blk_off, "blk_L": blk_L}, cols_flat, vals_flat,
                 x, bm=bm, mw=mw)
    if x.device.type == "cpu":
        return spmm_ell_fused_plain(blk_off, blk_L, cols_flat, vals_flat, x,
                                    bm=bm, mw=mw)
    num_blocks = blk_off.shape[0]
    d_pad = x.shape[1]
    y = torch.empty((num_blocks * bm, d_pad), dtype=torch.float32,
                    device=x.device)
    if num_blocks == 0 or d_pad == 0:
        return y
    ring = ring_route(d_pad)
    if ring:
        x = aligned16(x)
    lib = _build.load("spmm_ell_fused", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_ell_fused_launch(
            blk_off.data_ptr(), blk_L.data_ptr(), cols_flat.data_ptr(),
            vals_flat.data_ptr(), x.data_ptr(), y.data_ptr(),
            num_blocks // mw, bm, mw, d_pad,
            0 if ring else narrow_threads(d_pad),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_ell_fused launch failed with CUDA "
                           f"error {err}")
    spmm_ell_fused.launches += 1
    return y


spmm_ell_fused.launches = 0


# -- K3: the staged kernel, and the window arithmetic K3/K4 share ----------

# default slot capacity of the staging ring, in stream entries per slot
# and stream: a trip whose window is larger is walked in chunks
STAGE_CAP = 1024
# shared memory one CTA may use on an H100
MAX_SHARED_BYTES = 232448
COL_TILE = 128          # output columns per CTA (csrc/spmm_trips.cuh)
# K3/K4's rings (csrc/spmm_gather_ring.cuh): window slots and X stages,
# each with a full and an empty mbarrier of 8 bytes
RING_SLOTS = 3
X_STAGES = 4
MBARRIER_BYTES = 8
_INT_FILL = torch.iinfo(torch.int32).max    # an unfilled column entry


def staging_geometry(span: int, cspan: int, *, bm: int, bk: int = 1,
                     cap=None):
    """The ring a staged launch allocates, as ``(C, CH, KC)``.

    ``C`` is the slot capacity in entries: the workspace's window
    (``max(span, cspan)``), capped at ``cap`` (default
    :data:`STAGE_CAP`), at least one MXU step and 8 entries per row,
    rounded up to whole 16-byte copy units.  A slot holds ``C + 4``
    entries, room for a window copied from its 16-byte-aligned start.
    A trip whose own window exceeds ``C`` is walked member by member, in
    chunks: ``CH`` slots per row for a VPU descriptor (each row's
    segment copied to its own ``CH + 4``-entry row of the slot) or
    ``KC`` block steps for an MXU descriptor."""
    if span <= 0 or cspan <= 0:
        raise ValueError(f"the staged kernels need the workspace's "
                         f"windows, got span={span}, cspan={cspan}")
    limit = STAGE_CAP if cap is None else int(cap)
    c = max(min(max(int(span), int(cspan)), limit), 8 * bm, bm * bk)
    c = -(-c // 4) * 4
    return c, ((c + 4) // bm - 4) // 4 * 4, c // (bm * bk)


def ring_bytes(c: int, *, bm: int, bk: int) -> int:
    """Dynamic shared memory of one K3/K4 CTA: a full and an empty
    mbarrier for each of the :data:`RING_SLOTS` slots and
    :data:`X_STAGES` stages, the slots of ``c + 4`` entries for each of
    the value and column streams, and the X stages of ``max(bm, bk)``
    rows by one column tile (``csrc/spmm_gather_ring.cuh`` computes the
    same)."""
    barriers = 2 * (RING_SLOTS + X_STAGES) * MBARRIER_BYTES
    slots = 2 * RING_SLOTS * (c + 4) * 4
    return barriers + slots + X_STAGES * max(bm, bk) * COL_TILE * 4


def aligned(src: int, length: int):
    """The 16-byte-aligned span ``[a0, a1)`` a copy of stream entries
    ``[src, src + length)`` reads (empty when ``length`` is 0)."""
    if length <= 0:
        return src, src
    return src // 4 * 4, -(-(src + length) // 4) * 4


def copy_window(stream: torch.Tensor, src: int, length: int, slot: int,
                fill) -> torch.Tensor:
    """What a staged kernel finds in a ``slot``-entry buffer after
    copying stream entries ``[src, src + length)`` from the aligned-down
    start: the aligned span, then ``fill`` where nothing was copied.
    Entry ``src + i`` lands at ``src % 4 + i``."""
    a0, a1 = aligned(src, length)
    if a1 > stream.shape[0] or a1 - a0 > slot:
        raise IndexError(f"window [{a0}, {a1}) does not fit: stream of "
                         f"{stream.shape[0]} entries, slot of {slot}")
    buf = torch.full((slot,), fill, dtype=stream.dtype, device=stream.device)
    buf[:a1 - a0] = stream[a0:a1]
    return buf


def member_extents(tag, L, *, bm: int, bk: int):
    """Per-descriptor window sizes: ``bm*L`` slots and column entries
    for a VPU descriptor, ``L*bm*bk`` slots and ``L`` column entries for
    an MXU one (the planner's ``blk_span``/``blk_cspan`` terms)."""
    mxu = tag != 0
    return (torch.where(mxu, L * bm * bk, bm * L),
            torch.where(mxu, L, bm * L))


def staged_walk(tag, off, coff, L, *, bm: int, bk: int, mw: int, c: int,
                ch: int, kc: int):
    """The staged kernels' order of work: one item per merged trip whose
    window fits a slot, ``("trip", g, span, cspan)``, and for every
    other trip one item per chunk of each member in turn, ``("vpu", b,
    n0, n1)`` for steps ``[n0, n1)`` of a VPU descriptor and ``("mxu",
    b, k0, k1)`` for an MXU one; a member with no trips has one empty
    chunk.  Tables are int64 CPU tensors; the kernel computes the same
    items on the device."""
    span, cspan = member_extents(tag, L, bm=bm, bk=bk)
    t_span = span.view(-1, mw).sum(1).tolist()
    t_cspan = cspan.view(-1, mw).sum(1).tolist()
    tags, Ls = tag.tolist(), L.tolist()
    for g, (sp, cs) in enumerate(zip(t_span, t_cspan)):
        if sp <= c and cs <= c:
            yield ("trip", g, sp, cs)
            continue
        for b in range(g * mw, (g + 1) * mw):
            step = kc if tags[b] else ch
            kind = "mxu" if tags[b] else "vpu"
            for s0 in range(0, max(Ls[b], 1), step):
                yield (kind, b, s0, min(Ls[b], s0 + step))


def staged_plain(tag, off, coff, L, cols_flat, vals_flat, x, *, bm: int,
                 bk: int, mw: int, span: int, cspan: int, cap,
                 mxu_steps=None) -> torch.Tensor:
    """Plain PyTorch version of a staged kernel (K3 with ``tag`` all VPU
    and ``coff == off``, K4 with ``mxu_steps``): (B*bm, d_pad) workspace
    rows.  The trips that fit a slot run together, vectorised as in the
    resident versions but reading their slots and columns from buffers
    copied the way the kernel copies them; the chunked trips run chunk
    by chunk, in :func:`staged_walk`'s order."""
    c, ch, kc = staging_geometry(span, cspan, bm=bm, bk=bk, cap=cap)
    slot = c + 4
    dev = x.device
    acc = torch.zeros((L.shape[0], bm, x.shape[1]), dtype=torch.float32,
                      device=dev)
    chunks = []
    fit = []
    for item in staged_walk(tag.cpu(), off.cpu(), coff.cpu(), L.cpu(),
                            bm=bm, bk=bk, mw=mw, c=c, ch=ch, kc=kc):
        (fit if item[0] == "trip" else chunks).append(item)
    if fit:
        _fitting_trips(acc, fit, tag, off, coff, L, cols_flat, vals_flat, x,
                       bm=bm, bk=bk, mw=mw, slot=slot, mxu_steps=mxu_steps)
    rr = torch.arange(bm, device=dev)
    for kind, b, s0, s1 in chunks:
        Lb, ob, cb = int(L[b]), int(off[b]), int(coff[b])
        if s1 <= s0:
            continue
        if kind == "vpu":
            # row r's segment [r*L + s0, r*L + s1) in its own slot row
            vb = torch.cat([copy_window(vals_flat, ob + r * Lb + s0, s1 - s0,
                                        ch + 4, float("nan"))
                            for r in range(bm)])
            cbuf = torch.cat([copy_window(cols_flat, cb + r * Lb + s0,
                                          s1 - s0, ch + 4, _INT_FILL)
                              for r in range(bm)])
            vrow = rr * (ch + 4) + (ob + rr * Lb + s0) % 4
            crow = rr * (ch + 4) + (cb + rr * Lb + s0) % 4
            for nz in range(s1 - s0):
                v = vb[vrow + nz]
                k = cbuf[crow + nz].long()
                acc[b] = acc[b] + v[:, None] * x[k]
        else:
            step = bm * bk
            vb = copy_window(vals_flat, ob + s0 * step, (s1 - s0) * step,
                             slot, float("nan"))
            cbuf = copy_window(cols_flat, cb + s0, s1 - s0, slot, _INT_FILL)
            # the chunk as one descriptor of s1 - s0 steps on its buffers
            one = torch.zeros(1, dtype=torch.long, device=dev)
            mxu_steps(acc[b:b + 1], one, one + (ob + s0 * step) % 4,
                      one + (cb + s0) % 4, one + (s1 - s0), cbuf, vb, x,
                      bm=bm, bk=bk)
    return acc.reshape(-1, x.shape[1])


def _fitting_trips(acc, items, tag, off, coff, L, cols_flat, vals_flat, x,
                   *, bm, bk, mw, slot, mxu_steps):
    """Every trip whose window fits a slot, at once: the resident trip
    loops run on :func:`fitting_buffers`."""
    members, soff, scoff, cbuf, vbuf = fitting_buffers(
        items, off, coff, cols_flat, vals_flat, mw=mw, slot=slot)
    mxu = tag[members] != 0
    vpu_trips(acc, members[~mxu], soff, scoff, L, cbuf, vbuf, x, bm=bm)
    if mxu_steps is not None:
        mxu_steps(acc, members[mxu], soff, scoff, L, cbuf, vbuf, x, bm=bm,
                  bk=bk)


def fitting_buffers(items, off, coff, cols_flat, vals_flat, *, mw: int,
                    slot: int):
    """The buffers of the trips ``items`` (``("trip", g, span, cspan)``)
    whose windows fit a slot: each trip's value and column windows
    copied from their aligned-down starts into its own ``slot``-entry
    row (NaN / out-of-range beyond what was copied).  Returns the member
    descriptors, every descriptor's offsets rebased into its trip's
    buffer (``soff``, ``scoff``; 0 for the others), and the two
    flattened buffers."""
    dev = vals_flat.device
    g = torch.tensor([it[1] for it in items], device=dev)
    t_span = torch.tensor([it[2] for it in items], device=dev)
    t_cspan = torch.tensor([it[3] for it in items], device=dev)
    first = g * mw
    vbuf, va = _windows(vals_flat, off[first], t_span, slot, float("nan"))
    cbuf, ca = _windows(cols_flat, coff[first], t_cspan, slot, _INT_FILL)
    members = (first[:, None] + torch.arange(mw, device=dev)).reshape(-1)
    base = torch.arange(len(items), device=dev).repeat_interleave(mw) * slot
    soff = torch.zeros_like(off)
    scoff = torch.zeros_like(coff)
    soff[members] = base + off[members] - va.repeat_interleave(mw)
    scoff[members] = base + coff[members] - ca.repeat_interleave(mw)
    return members, soff, scoff, cbuf, vbuf


def _windows(stream, src, length, slot: int, fill):
    """Batched :func:`copy_window`: one ``slot``-entry row per window,
    flattened, and each window's aligned start."""
    a0 = src // 4 * 4
    a1 = torch.where(length > 0, (src + length + 3) // 4 * 4, a0)
    if bool((a1 > stream.shape[0]).any()) or bool((a1 - a0 > slot).any()):
        raise IndexError("a staged window runs past its stream or slot")
    pos = a0[:, None] + torch.arange(slot, device=stream.device)
    copied = pos < a1[:, None]
    buf = stream[pos.clamp(max=max(stream.shape[0] - 1, 0))]
    buf = torch.where(copied, buf, torch.full_like(buf, fill))
    return buf.reshape(-1), a0


def check_staged(x, cols_flat, vals_flat, *, c: int, bm: int,
                 bk: int) -> None:
    """What a staged launch needs beyond :func:`check_tables`: whole
    column tiles, a ring that fits a CTA, and (on the card) X and the
    column and value streams on 16-byte boundaries for the copies."""
    if x.shape[1] % COL_TILE:
        raise ValueError(f"the staged kernels take x with a multiple of "
                         f"{COL_TILE} columns, got {x.shape[1]}")
    nbytes = ring_bytes(c, bm=bm, bk=bk)
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"a staging ring of {nbytes} bytes exceeds the "
                         f"{MAX_SHARED_BYTES} bytes a CTA may use")
    if x.device.type == "cuda":
        for name, t in (("cols_flat", cols_flat), ("vals_flat", vals_flat),
                        ("x", x)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary "
                                 f"for the staged kernels' copies")


def spmm_ell_fused_staged_plain(blk_off, blk_L, cols_flat, vals_flat, x, *,
                                span: int, cspan: int, bm: int = 8,
                                mw: int = 1, cap=None) -> torch.Tensor:
    """Plain PyTorch K3: (B*bm, d_pad) workspace rows, through the same
    windows and chunks as the kernel (:func:`staged_plain`)."""
    off, L = _long(blk_off, blk_L)
    return staged_plain(torch.zeros_like(L), off, off, L, cols_flat,
                        vals_flat, x, bm=bm, bk=1, mw=mw, span=span,
                        cspan=cspan, cap=cap)


def spmm_ell_fused_staged(blk_off, blk_L, cols_flat, vals_flat, x, *,
                          span: int, cspan: int, bm: int = 8, mw: int = 1,
                          cap=None) -> torch.Tensor:
    """The staged fused dispatch (DESIGN.md §7.7) — :func:`spmm_ell_fused`'s
    contract and bit-identical output.

    ``span``/``cspan`` are the workspace's ``max_span``/``max_cspan``:
    they size the ring's slots (capped at ``cap``, default
    :data:`STAGE_CAP` entries), and the streams' tail padding of
    ``max_span`` entries keeps every aligned window copy in bounds.
    ``x`` has a multiple of 128 columns.

    CPU tensors run :func:`spmm_ell_fused_staged_plain`; CUDA tensors
    launch ``csrc/spmm_ell_fused_staged.cu`` once (counted in
    ``spmm_ell_fused_staged.launches``).
    """
    check_tables({"blk_off": blk_off, "blk_L": blk_L}, cols_flat, vals_flat,
                 x, bm=bm, mw=mw)
    c, ch, _ = staging_geometry(span, cspan, bm=bm, cap=cap)
    check_staged(x, cols_flat, vals_flat, c=c, bm=bm, bk=1)
    if x.device.type == "cpu":
        return spmm_ell_fused_staged_plain(blk_off, blk_L, cols_flat,
                                           vals_flat, x, span=span,
                                           cspan=cspan, bm=bm, mw=mw,
                                           cap=cap)
    num_blocks = blk_off.shape[0]
    d_pad = x.shape[1]
    y = torch.empty((num_blocks * bm, d_pad), dtype=torch.float32,
                    device=x.device)
    if num_blocks == 0:
        return y
    lib = _build.load("spmm_ell_fused_staged", _STAGED_ARGTYPES)
    with torch.cuda.device(x.device):
        err = lib.spmm_ell_fused_staged_launch(
            blk_off.data_ptr(), blk_L.data_ptr(), cols_flat.data_ptr(),
            vals_flat.data_ptr(), x.data_ptr(), y.data_ptr(),
            num_blocks // mw, bm, mw, d_pad, c, ch,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"spmm_ell_fused_staged launch failed with CUDA "
                           f"error {err}")
    spmm_ell_fused_staged.launches += 1
    return y


spmm_ell_fused_staged.launches = 0


# -- K8: the sharded dispatch, one launch per chip ---------------------------

def _ell_sharded(blk_off, blk_L, cols_flat, vals_flat, x, *, mesh, bm, mw,
                 staging, span, cspan, x_sharding, x_send, x_recv, cap,
                 plain: bool):
    check_on_mesh(mesh, blk_off=blk_off, blk_L=blk_L, cols_flat=cols_flat,
                  vals_flat=vals_flat, x=x, x_send=x_send, x_recv=x_recv)
    if staging == "dma":
        kernel = (spmm_ell_fused_staged_plain if plain
                  else spmm_ell_fused_staged)
    else:
        kernel = spmm_ell_fused_plain if plain else spmm_ell_fused
    xs = sharded_x(x, mesh, x_sharding, x_send, x_recv)
    return run_on_chips(kernel, (blk_off, blk_L, cols_flat, vals_flat),
                        [(xc,) for xc in xs], mesh=mesh, staging=staging,
                        span=span, cspan=cspan, cap=cap,
                        knobs=dict(bm=bm, mw=mw),
                        counter=None if plain else spmm_ell_fused_sharded)


def spmm_ell_fused_sharded(blk_off, blk_L, cols_flat, vals_flat, x, *, mesh,
                           bm: int = 8, mw: int = 1,
                           staging: str = "resident", span=0, cspan=0,
                           x_sharding: str = "replicated", x_send=None,
                           x_recv=None, cap=None) -> torch.Tensor:
    """K8 for ``pallas_ell``: one K1 (``resident``) or K3 (``dma``) launch
    per chip of ``mesh`` (a ``ChipMesh``), each on its chip's device.

    blk_off/blk_L : (C, B) int32 — per-chip descriptor tables
    cols_flat     : (C, Sc) int32 — per-chip slot -> X row (rows of the
                    chip's compact X workspace under ``"rows"``)
    vals_flat     : (C, S) float32 — per-chip slot values
    x             : (n, d_pad) float32 when replicated; the stacked
                    (C, P, bk, d_pad) owned-panel strips under ``"rows"``
    span/cspan    : the staged windows, an int or one per chip
                    (``ShardedFusedWorkspace.chip_span``/``chip_cspan``)

    Tables may be stacked tensors or sequences of per-chip tensors;
    every operand must lie on the mesh's device type.  Under
    ``x_sharding="rows"`` the exact-panel exchange runs first, over the
    ``x_send`` (C, C, T2) and ``x_recv`` (C, T) tables.  Returns the
    (C, B*bm, d_pad) workspace rows in chip order, on the first chip's
    device; the caller flattens them and applies the sharded
    workspace's GLOBAL ``inv_perm``.  Each chip's launch counts in its
    kernel's ``launches`` and in ``spmm_ell_fused_sharded.launches``.
    """
    return _ell_sharded(blk_off, blk_L, cols_flat, vals_flat, x, mesh=mesh,
                        bm=bm, mw=mw, staging=staging, span=span, cspan=cspan,
                        x_sharding=x_sharding, x_send=x_send, x_recv=x_recv,
                        cap=cap, plain=False)


spmm_ell_fused_sharded.launches = 0


def spmm_ell_fused_sharded_plain(blk_off, blk_L, cols_flat, vals_flat, x, *,
                                 mesh, bm: int = 8, mw: int = 1,
                                 staging: str = "resident", span=0, cspan=0,
                                 x_sharding: str = "replicated", x_send=None,
                                 x_recv=None, cap=None) -> torch.Tensor:
    """Plain PyTorch K8 for ``pallas_ell``: the same chip loop and
    exchange through :func:`spmm_ell_fused_plain` /
    :func:`spmm_ell_fused_staged_plain`."""
    return _ell_sharded(blk_off, blk_L, cols_flat, vals_flat, x, mesh=mesh,
                        bm=bm, mw=mw, staging=staging, span=span, cspan=cspan,
                        x_sharding=x_sharding, x_send=x_send, x_recv=x_recv,
                        cap=cap, plain=True)
