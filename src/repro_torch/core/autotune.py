"""Runtime-feedback autotuner for the fused SpMM dispatch (port of
``src/repro/core/autotune.py``).

The plan pipeline exposes the per-instance knobs — ``strategy``
(row/nnz/merge split), ``bm``/``bk`` tiling, ``mxu_gain`` tagging, the
CGCM ``merge_threshold`` and the operand ``staging`` (K1/K2 resident,
K3/K4 staged).  This module picks them in two stages (DESIGN.md §11):

  predict  rank every candidate :class:`TuneConfig` with the analytic
           roofline terms (``analysis.roofline``'s H100 rates +
           ``analysis.memmodel.spmm_hbm_traffic`` on the candidate's
           OWN packed workspace) plus a per-trip launch overhead — the
           term CGCM merging shrinks.  Host-only, no device work.
  measure  compile the top-K predicted candidates through
           ``compile_spmm`` (same jit cache — the search warms it) and
           time real forwards: on the card the minimum of CUDA-event
           timings, on the CPU of ``time.perf_counter`` ones.  The hook
           is injectable, so tests run on a deterministic fake timer.

The winning config is memoized in the :class:`~repro_torch.core.
jit_cache.JitCache` under a ``("spmm_tune", ...)`` key, so the second
``autotune=True`` compile is a cache hit and runs no search.  The key
carries the resolved ``device`` where the reference carries
``interpret``.  Search wall time lands in
``kernels.ops.BUILD_SECONDS["tune"]``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .csr import CSRMatrix
from .jit_cache import GLOBAL_CACHE, JitCache, mesh_fingerprint
from .plan import build_workspace
from ..analysis.memmodel import spmm_hbm_traffic
from ..analysis.roofline import HBM_BW, PEAK_FLOPS

# per-trip launch/descriptor overhead (s).  NOT a measurement of the
# card: it is the reference's tie-break weight, kept so that the two
# packages rank candidates alike under equal constants.  It only has to
# be the right order of magnitude to break ties between plans whose
# streamed bytes are close, in favour of fewer merged trips.
# chip_smoke.py prints each finalist's predicted and measured ms, the
# data a calibration for the card would start from.
TRIP_OVERHEAD_S = 2e-6

STRATEGIES = ("row_split", "nnz_split", "merge_split")


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One point of the search space — the per-instance knobs the
    dispatch stack bakes into its jit-cache keys."""
    strategy: str = "nnz_split"
    bm: int = 8
    bk: int = 8
    mxu_gain: float = 4.0
    merge_threshold: int = 0
    staging: str = "resident"

    def compile_kwargs(self) -> dict:
        return {"strategy": self.strategy, "bm": self.bm, "bk": self.bk,
                "mxu_gain": self.mxu_gain,
                "merge_threshold": self.merge_threshold,
                "staging": self.staging}


@dataclasses.dataclass
class TuneResult:
    """The memoized outcome of one search: the winner plus the full
    ranking (predicted seconds for every candidate, measured seconds
    for the finalists)."""
    config: TuneConfig
    predicted_s: dict           # TuneConfig -> predicted seconds
    measured_s: dict            # TuneConfig -> measured seconds (top-K)
    tune_seconds: float = 0.0

    @property
    def best_measured_s(self) -> float:
        return self.measured_s[self.config]


def default_candidates(*, bm: int = 8, bk: int = 8,
                       mxu_gain: float = 4.0,
                       staging: str = "resident",
                       merge_thresholds: Sequence[int] = (0, 8, 32)
                       ) -> List[TuneConfig]:
    """The default grid: every strategy × CGCM threshold at the caller's
    tiling/staging.  Callers with wider budgets pass their own list (any
    ``TuneConfig`` field may vary — bm/bk/mxu_gain/staging included)."""
    return [TuneConfig(strategy=s, bm=bm, bk=bk, mxu_gain=mxu_gain,
                       merge_threshold=t, staging=staging)
            for s in STRATEGIES for t in merge_thresholds]


def predict_seconds(a: CSRMatrix, d: int, cfg: TuneConfig, *,
                    mixed: bool = False) -> float:
    """Analytic forward-time estimate for one candidate: the roofline
    max of compute and memory terms on the candidate's own packed
    workspace, plus the per-trip launch overhead.  Host-only."""
    ws = build_workspace(
        a.row_ptr, a.col_indices, a.shape, d, strategy=cfg.strategy,
        row_block=cfg.bm, mixed=mixed, bk=cfg.bk, mxu_gain=cfg.mxu_gain,
        merge_threshold=cfg.merge_threshold)
    d_pad = max(-(-d // 128) * 128, 128)
    traffic = spmm_hbm_traffic(
        slots=int(ws.gather_flat.shape[0]),
        cols_entries=int(ws.cols_flat.shape[0]),
        padded_nnz=int(ws.gather_flat.shape[0]),
        ws_rows=ws.ws_rows, d_pad=d_pad)
    compute_s = 2.0 * a.nnz * d / PEAK_FLOPS
    memory_s = sum(traffic.values()) / HBM_BW
    return max(compute_s, memory_s) + ws.num_trips * TRIP_OVERHEAD_S


def spmm_tune_key(a: CSRMatrix, d: int, *, backend: str, device: str,
                  x_sharding: str, mesh,
                  candidates: Sequence[TuneConfig],
                  top_k: int = 3) -> Tuple:
    """The memoization key for one search — factored out so the batched
    knob resolver (DESIGN.md §14.3) can *peek* a member's winner with
    exactly the key its solo warmup used.  ``top_k`` is part of the
    search's identity: it sets which predicted candidates get MEASURED,
    so two searches with different ``top_k`` can crown different
    winners."""
    return ("spmm_tune", a.fingerprint, d, backend, device, x_sharding,
            mesh_fingerprint(mesh),
            tuple(dataclasses.astuple(c) for c in candidates),
            max(int(top_k), 1))


def lookup_tune_result(a: CSRMatrix, d: int, *, backend: str,
                       device: str, x_sharding: str = "replicated",
                       mesh=None,
                       candidates: Sequence[TuneConfig],
                       top_k: int = 3,
                       cache: JitCache = GLOBAL_CACHE
                       ) -> Optional[TuneResult]:
    """The memoized :class:`TuneResult` for one instance, or ``None``
    when its search has not run (or was evicted).  Never builds and
    never touches cache stats/recency — safe on the dispatch path.
    ``device`` is the RESOLVED device string, as the key holds it."""
    key = spmm_tune_key(a, d, backend=backend, device=device,
                        x_sharding=x_sharding, mesh=mesh,
                        candidates=list(candidates), top_k=top_k)
    return cache.peek(key)


def resolve_batch_config(results: Sequence[Optional[TuneResult]],
                         fallback: TuneConfig) -> TuneConfig:
    """One static configuration for a batched dispatch from the members'
    memoized solo winners (DESIGN.md §14.3): ``strategy``/``bm``/``bk``/
    ``mxu_gain``/``staging`` by majority vote (ties broken toward the
    fallback, then toward the earliest member) and ``merge_threshold``
    by *min*, the conservative CGCM bound.  Members with no memoized
    result vote for the fallback."""
    votes = [r.config if r is not None else fallback for r in results]
    if not votes:
        return fallback

    def _majority(field: str):
        tally: dict = {}
        order: list = []
        for v in votes:
            val = getattr(v, field)
            if val not in tally:
                order.append(val)
            tally[val] = tally.get(val, 0) + 1
        best = max(tally.values())
        tied = [val for val in order if tally[val] == best]
        fb = getattr(fallback, field)
        return fb if fb in tied else tied[0]

    return TuneConfig(
        strategy=_majority("strategy"), bm=_majority("bm"),
        bk=_majority("bk"), mxu_gain=_majority("mxu_gain"),
        merge_threshold=min(v.merge_threshold for v in votes),
        staging=_majority("staging"))


def device_time_measure(compiled, vals, x, *, repeats: int = 3) -> float:
    """Default measurement hook, in seconds: one warm-up forward, then
    the minimum of ``repeats`` timed forwards — CUDA events around each
    on the card, ``time.perf_counter`` around each on the CPU."""
    with torch.no_grad():
        compiled(vals, x)
        if x.device.type != "cuda":
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                compiled(vals, x)
                best = min(best, time.perf_counter() - t0)
            return best
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            compiled(vals, x)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
        return best


def autotune_spmm(a: CSRMatrix, d: int, **kw):
    """Search the plan space for this instance and return the winning
    compiled artifact (``compile_spmm`` of the winner — a jit-cache hit
    when the search already ran).  Takes the keywords of
    :func:`autotune_spmm_with_result`."""
    compiled, _ = autotune_spmm_with_result(a, d, **kw)
    return compiled


def autotune_spmm_with_result(
        a: CSRMatrix, d: int, *, backend: str = "auto", bm: int = 8,
        bk: int = 8, mxu_gain: float = 4.0,
        device: Optional[str] = None, mesh=None,
        n_chips: Optional[int] = None, staging: Optional[str] = None,
        x_sharding: Optional[str] = None,
        validate: Optional[str] = None,
        candidates: Optional[Sequence[TuneConfig]] = None,
        measure: Optional[Callable] = None, top_k: int = 3,
        cache_priority: float = 0.0,
        cache: JitCache = GLOBAL_CACHE) -> Tuple[object, TuneResult]:
    """:func:`autotune_spmm` plus the full :class:`TuneResult`.
    ``measure(compiled, vals, x) -> seconds`` is injectable
    (:func:`device_time_measure` by default)."""
    from .spmm import (FUSED_BACKENDS, _resolve_backend, _resolve_mesh_for,
                       _resolve_staging_for, _resolve_x_sharding_for,
                       compile_spmm)
    from ..kernels.ops import (record_build_seconds, resolve_device,
                               resolve_validate)

    device = resolve_device(device)
    backend = _resolve_backend(
        backend, device, sharded=mesh is not None or n_chips is not None)
    if backend not in FUSED_BACKENDS:
        raise ValueError(
            f"autotune searches the fused plan space "
            f"({'/'.join(FUSED_BACKENDS)}); backend={backend!r} has "
            f"nothing to tune")
    # validate never joins the tune key: verification cannot change a
    # search's winner (it only gates compilation)
    validate = resolve_validate(validate, device)
    staging_r = _resolve_staging_for(backend, staging, device)
    mesh = _resolve_mesh_for(backend, mesh, n_chips, device)
    x_sharding = _resolve_x_sharding_for(backend, x_sharding, mesh)
    if candidates is None:
        candidates = default_candidates(bm=bm, bk=bk, mxu_gain=mxu_gain,
                                        staging=staging_r)
    candidates = list(candidates)
    if not candidates:
        raise ValueError("autotune needs at least one candidate config")
    measure = measure or device_time_measure
    mixed = backend == "pallas_bcsr"

    key = spmm_tune_key(a, d, backend=backend, device=device,
                        x_sharding=x_sharding, mesh=mesh,
                        candidates=candidates, top_k=top_k)

    def _search() -> TuneResult:
        t0 = time.perf_counter()
        predicted = {c: predict_seconds(a, d, c, mixed=mixed)
                     for c in candidates}
        ranked = sorted(candidates, key=lambda c: predicted[c])
        finalists = ranked[:max(int(top_k), 1)]
        vals = a.vals.to(device)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(
            rng.standard_normal((a.shape[1], d)).astype(np.float32)).to(
                device)
        measured = {}
        for c in finalists:
            compiled_c = compile_spmm(
                a, d, backend=backend, device=device, mesh=mesh,
                x_sharding=x_sharding, validate=validate, cache=cache,
                **c.compile_kwargs())
            measured[c] = float(measure(compiled_c, vals, x))
        # stable tie-break: measured time, then predicted rank — a
        # constant fake timer degenerates to the predicted order
        winner = min(finalists,
                     key=lambda c: (measured[c], predicted[c]))
        res = TuneResult(config=winner, predicted_s=predicted,
                         measured_s=measured,
                         tune_seconds=time.perf_counter() - t0)
        record_build_seconds("tune", res.tune_seconds)
        return res

    result: TuneResult = cache.get_or_build(key, _search,
                                            priority=cache_priority)
    compiled = compile_spmm(
        a, d, backend=backend, device=device, mesh=mesh,
        x_sharding=x_sharding, validate=validate,
        cache_priority=cache_priority,
        cache=cache, **result.config.compile_kwargs())
    return compiled, result
