"""Unique-row dedup + persistent LRU cache for the DVFS solvers.

Every scheduler path funnels through one solver shape: a batch of rows
``(params, allowed, readjust, interval bounds)`` mapped independently to an
8-tuple solution ``(v, fc, fm, t, p, e, deadline_prior, feasible)``.  Two
structural facts make that batch massively redundant:

* traces are drawn from a small application library (the paper's benchmark
  apps; ``tasks.generate_trace`` patterns), so recurring jobs produce
  *duplicate rows* inside one call;
* sweep benchmarks re-solve the *same* rows cell after cell (θ-sweep cells
  share the task set; ``theoretical_bound`` is recomputed per scenario
  knob), so whole calls repeat *across* invocations.

This module removes both: :func:`solve_rows` quantizes the rows to the
solver's own f32 precision, keeps only ``np.unique`` rows, serves
previously-solved rows from a process-wide LRU (:data:`GLOBAL_CACHE`),
dispatches the solver on the residual misses only, and scatters the
solutions back via the unique-inverse.

**Bit-equality contract.**  The f32 key IS the solver input: every solver
(grid+golden and kernel) casts its params/allowed to f32 before computing, and all
of them are row-independent (elementwise math + per-row argmin), so a row's
solution does not depend on which other rows share the batch.  Dedup +
scatter therefore returns *bit-identical* solutions to the direct solve —
``tests/test_solver_cache.py`` pins this property end-to-end through both
schedulers.

Keys are ``[n, 13]`` f32 rows — exactly columns 0-12 of the kernel task
matrix (:mod:`repro_torch.kernels.dvfs_opt`):

    (p0, γ, c, D, δ, t0, allowed, readjust,
     v_min, v_max, fc_min, fm_min, fm_max)

Cache entries are namespaced by a solver ``tag`` ("k64x64" for the kernel
at that refinement grid, "torch-dl"/"torch-bd"/"torch-unc" for the
grid+golden deadline/boundary/unconstrained solvers), each suffixed with the
device type that ran it ("k64x64@cuda", "torch-dl@cpu"), so numerically
different solvers — the CUDA kernel and its plain version on the CPU among
them — never serve each other's rows.

Solvers may return their rows as a CUDA tensor still being computed: the
copy to the host happens only in :meth:`AsyncSolve.result`, so a launch
overlaps whatever the host does between dispatch and consumption.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import layout
from repro_torch.kernels.layout import DvfsSolution, KEY_COLS, SOL_COLS

#: Pad the miss batch so the solvers see a bounded set of
#: shapes, not one per unique-row count: powers of two (>= 8) up to
#: _PAD_BLOCK, multiples of _PAD_BLOCK above it.  Capping the pow-2
#: rounding matters for the chunked online pipeline — a stream of ~4k-row
#: chunks would otherwise pad each one to 8192 and nearly double the
#: device work.
_MIN_PAD = 8
_PAD_BLOCK = 1024


class SolveCache:
    """LRU map from ``(tag, row-bytes)`` to an 8-float solution row.

    Sized in *rows*; the default :data:`GLOBAL_CACHE` keeps 2^18 rows
    (~25 MB of keys+values), far above any single sweep's working set.
    ``hits``/``misses`` accumulate across calls — sweep benchmarks report
    them as the cross-cell reuse rate.
    """

    def __init__(self, maxsize: int = 1 << 18):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._rows: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Lifetime counters: same increments, never cleared by
        # ``reset_stats`` — ``schedule_online`` resets the per-run counters
        # at every call, so cross-run consumers (sweep benchmarks) diff
        # these instead.
        self.hits_total = 0
        self.misses_total = 0
        self.evictions_total = 0

    def __len__(self) -> int:
        return len(self._rows)

    def get(self, tag: str, key: bytes) -> Optional[np.ndarray]:
        row = self._rows.get((tag, key))
        if row is None:
            self.misses += 1
            self.misses_total += 1
            return None
        self._rows.move_to_end((tag, key))  # refresh LRU position
        self.hits += 1
        self.hits_total += 1
        return row

    def put(self, tag: str, key: bytes, value: np.ndarray) -> None:
        k = (tag, key)
        self._rows[k] = value
        self._rows.move_to_end(k)
        while len(self._rows) > self.maxsize:
            self._rows.popitem(last=False)
            self.evictions += 1
            self.evictions_total += 1

    def get_many(self, tag: str, keys: np.ndarray,
                 out: np.ndarray) -> tuple:
        """Batch :meth:`get` over the rows of a contiguous ``[m, k]`` key
        matrix: hits are written into ``out`` (same row index) and counted;
        returns ``(miss_idx, miss_keys)`` — the miss row indices and their
        ready-made ``(tag, row-bytes)`` dict keys, which :meth:`put_keys`
        inserts without re-serializing.  One ``tobytes`` of the whole
        matrix + constant-stride slicing beats a per-row ``ndarray.tobytes``
        by ~4x on the 100k-row batches the online pipeline feeds through."""
        rows = self._rows
        get = rows.get
        move = rows.move_to_end
        stride = keys.shape[1] * keys.itemsize
        buf = keys.tobytes()
        miss: list = []
        miss_keys: list = []
        append = miss.append
        append_key = miss_keys.append
        hits = 0
        for i in range(keys.shape[0]):
            k = (tag, buf[i * stride:(i + 1) * stride])
            row = get(k)
            if row is None:
                append(i)
                append_key(k)
            else:
                move(k)
                out[i] = row
                hits += 1
        self.hits += hits
        self.hits_total += hits
        self.misses += len(miss)
        self.misses_total += len(miss)
        return miss, miss_keys

    def put_keys(self, keys: list, values: list) -> None:
        """Batch :meth:`put` under pre-built ``(tag, row-bytes)`` keys (the
        ``miss_keys`` of a :meth:`get_many` call).  Rows are assumed new,
        so the C-level ``dict.update`` lands them at the LRU tail exactly
        like :meth:`put` would."""
        rows = self._rows
        rows.update(zip(keys, values))
        if len(rows) > self.maxsize:
            pop = rows.popitem
            while len(rows) > self.maxsize:
                pop(last=False)
                self.evictions += 1
                self.evictions_total += 1

    def clear(self) -> None:
        self._rows.clear()

    def reset_stats(self) -> None:
        """Zero the per-run counters (``hits``/``misses``/``evictions``);
        the ``*_total`` lifetime counters keep accumulating."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"rows": len(self), "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "hits_total": self.hits_total,
                "misses_total": self.misses_total,
                "evictions_total": self.evictions_total}


#: The process-wide cache every ``dedup=True`` solver call shares.
GLOBAL_CACHE = SolveCache()


def build_keys(param_cols: Sequence[np.ndarray], allowed: np.ndarray,
               readjust: bool, bounds: np.ndarray) -> np.ndarray:
    """Assemble the ``[n, 13]`` f32 key matrix (= kernel columns 0-12).

    ``param_cols`` are the six ``DvfsParams`` columns; ``bounds`` is either
    a 5-vector (one interval for all rows) or an ``[n, 5]`` per-row matrix.
    """
    cols = [np.asarray(c, np.float32) for c in param_cols]
    n = cols[0].shape[0]
    flag = np.full(n, 1.0 if readjust else 0.0, np.float32)
    bounds = np.asarray(bounds, np.float32)
    if bounds.ndim == 1:
        bounds = np.broadcast_to(bounds, (n, layout.N_BOUNDS))
    keys = np.concatenate(
        [np.stack(cols + [np.asarray(allowed, np.float32), flag], axis=1),
         bounds], axis=1)
    assert keys.shape == (n, KEY_COLS)
    return np.ascontiguousarray(keys, np.float32)


def _pad_rows(mat: np.ndarray) -> np.ndarray:
    """Pad the row count up to the solver shape grid — the next power of
    two (>= _MIN_PAD) below _PAD_BLOCK, the next _PAD_BLOCK multiple above
    it — replicating the last row, which is safe because every solver is
    row-independent."""
    k = mat.shape[0]
    if k <= _PAD_BLOCK:
        k_pad = max(_MIN_PAD, 1 << (k - 1).bit_length())
    else:
        k_pad = -(-k // _PAD_BLOCK) * _PAD_BLOCK
    if k_pad == k:
        return mat
    return np.concatenate(
        [mat, np.broadcast_to(mat[-1], (k_pad - k, mat.shape[1]))], axis=0)


def to_numpy(x) -> np.ndarray:
    """A host numpy array of ``x``: a tensor on any device is copied to the
    host (for a CUDA tensor this waits until the work producing it is
    done); anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _materialize(pending) -> np.ndarray:
    """Resolve an in-flight solver result to a host f32 matrix.  Accepts a
    zero-arg callable (a deferred gather), a tensor on any device (a CUDA
    tensor blocks until the launched computation lands), or a plain
    ndarray."""
    while callable(pending):
        pending = pending()
    return np.asarray(to_numpy(pending), np.float32)


class AsyncSolve:
    """Handle for a dispatched-but-not-consumed dedup solve.

    Created by :func:`solve_rows_async` after the host-side work (unique,
    cache probe, dispatch of the misses) is done; the device computation —
    if any — runs concurrently with whatever the host does next.

    :meth:`result` is the single sync point: it blocks on the device
    values, validates the shape, feeds the cache and scatters through the
    unique-inverse.  It is memoized, so calling it twice is free.

    State changes on the host between dispatch and consumption (placement,
    server power-off, fault injection) cannot change the values: the key
    matrix was snapshotted at dispatch time and every solver is
    row-independent, so the rows solve to the same bits no matter when —
    or beside what — they are computed.
    """

    __slots__ = ("_inverse", "_out", "_miss", "_miss_keys", "_pending",
                 "_cache", "_result")

    def __init__(self, inverse, out, miss, miss_keys, pending, cache):
        self._inverse = inverse
        self._out = out
        self._miss = miss
        self._miss_keys = miss_keys
        self._pending = pending
        self._cache = cache
        self._result: Optional[np.ndarray] = None

    @property
    def in_flight(self) -> bool:
        """True until :meth:`result` has materialized the solve."""
        return self._result is None

    @property
    def n_missing(self) -> int:
        """Unique rows actually dispatched (cache misses)."""
        return len(self._miss)

    def result(self) -> np.ndarray:
        """Block on the dispatched solve and return ``[n, 8]`` f32 rows."""
        if self._result is None:
            miss = self._miss
            if miss:
                solved = _materialize(self._pending)[:len(miss)]
                if solved.shape != (len(miss), SOL_COLS):
                    raise ValueError(
                        f"solver_fn returned {solved.shape}, expected "
                        f"{(len(miss), SOL_COLS)}")
                solved = np.ascontiguousarray(solved)
                if len(miss) == self._out.shape[0]:
                    self._out = solved
                else:
                    self._out[miss] = solved
                if self._cache is not None:
                    self._cache.put_keys(self._miss_keys, list(solved))
            self._pending = None
            self._miss_keys = None
            self._result = self._out if self._inverse is None \
                else self._out[self._inverse]
        return self._result


def solve_rows_async(keys: np.ndarray,
                     solver_fn: Callable[[np.ndarray], np.ndarray], *,
                     tag: str,
                     cache: Optional[SolveCache] = GLOBAL_CACHE,
                     unique: bool = True) -> AsyncSolve:
    """Non-blocking :func:`solve_rows`: dedup + cache probe + dispatch now,
    materialize later.

    ``solver_fn`` maps a ``[m, 13]`` f32 key matrix (possibly pad-row extended)
    to ``[m, 8]`` solution rows; it may return a plain ndarray, a tensor
    (a CUDA tensor is the asynchronous-launch fast path), or a zero-arg
    callable that yields either when invoked.
    The returned :class:`AsyncSolve` resolves to the same bits
    :func:`solve_rows` would return — call ``.result()`` at the pipeline's
    sync point.

    ``unique=False`` skips the sort-based ``np.unique`` pass and relies on
    the cache probe alone: intra-batch duplicate rows are each solved (to
    the same bits — solvers are row-independent) and each counted as a
    miss.  The pipelined online scheduler uses this: its chunks are nearly
    duplicate-free (distinct per-task deadlines), so the O(n log n) sort
    costs far more than the duplicate solves it saves, while *cross*-chunk
    repeats still hit the cache.  Values are bit-identical either way.
    """
    keys = np.ascontiguousarray(np.asarray(keys, np.float32))
    if keys.ndim != 2 or keys.shape[1] != KEY_COLS:
        raise ValueError(f"keys must be [n, {KEY_COLS}], got {keys.shape}")
    if unique:
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        inverse = np.asarray(inverse).reshape(-1)  # numpy 2.x shape compat
    else:
        uniq, inverse = keys, None
    m = uniq.shape[0]
    out = np.empty((m, SOL_COLS), np.float32)
    if cache is not None:
        miss, miss_keys = cache.get_many(tag, uniq, out)
    else:
        miss, miss_keys = list(range(m)), None
    sub = uniq if len(miss) == m else uniq[miss]
    pending = solver_fn(_pad_rows(sub)) if miss else None
    return AsyncSolve(inverse, out, miss, miss_keys, pending, cache)


def solve_rows(keys: np.ndarray,
               solver_fn: Callable[[np.ndarray], np.ndarray], *,
               tag: str,
               cache: Optional[SolveCache] = GLOBAL_CACHE) -> np.ndarray:
    """Dedup + cache + scatter around a row-independent solver.

    ``solver_fn`` maps a ``[m, 13]`` f32 key matrix (possibly pad-row extended)
    to ``[m, 8]`` solution rows.  Returns the ``[n, 8]`` f32 solutions for
    all input rows; rows equal as f32 vectors share one solve, and rows
    seen by a previous call (same ``tag``) are served from ``cache``
    without touching the solver at all.  ``cache=None`` dedups within the
    call but persists nothing.

    This is the blocking wrapper over :func:`solve_rows_async` — dispatch
    and consume back to back.
    """
    return solve_rows_async(keys, solver_fn, tag=tag, cache=cache).result()


def solution_to_rows(sol) -> np.ndarray:
    """Pack a ``DvfsSolution`` (8 same-length arrays or tensors) into
    ``[n, 8]`` f32 on the host — the cache's value layout (bool columns
    stored as 0.0/1.0)."""
    return np.stack([np.asarray(to_numpy(f), np.float32) for f in sol], axis=1)


def rows_to_solution(rows: np.ndarray) -> DvfsSolution:
    """Inverse of :func:`solution_to_rows`."""
    return DvfsSolution(
        v=rows[:, layout.SOL_V], fc=rows[:, layout.SOL_FC],
        fm=rows[:, layout.SOL_FM], time=rows[:, layout.SOL_T],
        power=rows[:, layout.SOL_P], energy=rows[:, layout.SOL_E],
        deadline_prior=rows[:, layout.SOL_DP] > 0.5,
        feasible=rows[:, layout.SOL_FEASIBLE] > 0.5)
