"""Online scheduling: EDL theta-readjustment + DRS, and the bin-packing
baseline (paper S4.2.2, Algorithms 4-6), as an event-driven simulation.

Time is divided into unit slots (one minute in the paper's day-long
simulation).  The system starts with an offline batch at ``T = 0``; online
tasks arrive at slots ``T >= 1`` (a fractional arrival is rounded *up* to
the next slot boundary — a task can never start, or have its DVFS window
measured, before it actually arrives).  The simulator advances arrival
group by arrival group; for each group at slot ``T`` it

1. *settles to T* - :meth:`~repro_torch.core.engine.ClusterEngine.settle` books
   every DRS power-off *event* that occurred since the previous group at
   its exact time: a server goes off ``rho`` slots after its last pair
   frees up and is billed ``mu + rho - on_since`` of powered-on span, no
   matter how sparse the arrival slots are.  (Power-on is already an
   event - it happens exactly when a task acquires a fresh pair - so with
   this step every on/off transition is billed at its event time and the
   per-slot sweep of Algorithm 4 is recovered exactly, without iterating
   arrival-free slots.)
2. *assigns the group's tasks* (Algorithm 5) - per-task optimal DVFS
   configuration first (deadline-aware, on every machine class), then EDF
   order; each task tries its classes min-energy-feasible first and goes
   to the ON pair of that class with the shortest processing time if it
   fits, else a theta-readjustment shrinks its execution window, else the
   next class; a task no class can host powers on a fresh server of its
   primary class.

The bin-packing baseline (Algorithm 6) replaces the pair-selection rule with
worst-fit on utilization for the offline batch and first-fit for online
arrivals, with no readjustment - the heuristic used by Liu et al. [41].

This module is a thin *driver*: every pair-selection path — the per-class
compact pools, the batched EDF-prefix placement with θ-readjustment rows,
the pooled first-fit probes, the lazy-heap scalar finish and the per-task
reference loop — lives in the shared placement subsystem
(:class:`repro_torch.core.placement.PlacementContext`), which also serves the
offline batch scheduler.  ``placement="vector"`` (default) runs the
batched paths, ``placement="scalar"`` the reference loop; both are
bit-identical (``tests/test_event_engine.py`` pins this on a mixed-class
horizon, ``benchmarks/online_scale.py`` guards the speedup).

Cluster state lives in :class:`~repro_torch.core.engine.ClusterEngine` (the same
vectorized pair/server arrays the offline scheduler packs into, including
the per-pair ``class_id`` column), and the per-task DVFS solves are
batched: a task's slot-relative window ``d - ceil(a)`` is known before the
simulation starts, so Algorithm 1 runs ONCE for the whole horizon and every
class (one widened kernel launch with ``use_kernel=True``), and the
theta-readjustment re-solves — whose windows only pin finish times, never
the packing decisions — are deferred and batch-solved per class at the end
(``single_task.readjust_batch``).

Energy accounting follows Eq. (7) with per-class constants:

    E_total = E_run + E_idle + E_overhead
            = sum_i P_i (mu_i - kappa_i)
              + sum_k P_idle[k] * idle periods of class k
              + sum_k Delta[k] * (class-k pair turn-ons)

and every result reports ``e_bound``, the §5 analytical lower bound
(:func:`repro_torch.core.bounds.theoretical_bound` with the DRS floors).

**Pipelined execution** (``pipeline=True``, the default): the driver cuts
the arrival groups into ~:data:`PIPELINE_CHUNK_TASKS`-task chunks and
double-buffers the DVFS solves against the host placement — chunk ``k+1``'s
Algorithm-1 batch is launched (CUDA launches are asynchronous; the host
never blocks on them) before the host places chunk ``k``, and the deferred
θ-readjustment boundary re-solves join the next in-flight batch at each
chunk boundary instead of forcing a run-end sync.  The vector placement
path additionally keeps its per-class candidate pools alive across arrival
groups (``PlacementContext(incremental=True)``) with delta reconciliation.
Both halves are bit-identical to the synchronous path by construction: the
f32 key matrix IS the solver input and every solver is row-independent, so
chunked solves return the same bits as one monolithic batch, and the
persistent pools are pinned against the per-group rebuild by the frontier
invariant (see :mod:`repro_torch.core.placement`).  ``pipeline=False`` runs the
reference path unchanged.  See docs/ARCHITECTURE.md (pipelined online
scheduling) for the dataflow diagram and the invalidation rules.

See docs/EQUATIONS.md for the full equation/algorithm -> code map.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core import bounds, cluster as cl, dvfs, machines, single_task
from repro_torch.core.dvfs import ScalingInterval
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.faults import FaultInjector, FaultTrace, make_degrade
from repro_torch.core.placement import PendingRow, PlacementContext
from repro_torch.core.scheduling import (chosen_feasibility, count_violations,
                                   fill_readjusted)
from repro_torch.core.single_task import TaskConfig
from repro_torch.core.tasks import TaskSet
from repro_torch.kernels import layout


def arrival_slots(task_set: TaskSet) -> np.ndarray:
    """Each task's arrival slot: ``ceil(a)`` — the first slot boundary at or
    after the arrival.  A task with a fractional arrival must wait for the
    next slot; grouping by ``floor`` would let it start before it arrives
    and grant it a too-wide DVFS window."""
    return np.ceil(np.asarray(task_set.arrival, dtype=np.float64))


def _slot_groups(task_set: TaskSet):
    """Group task indices by arrival slot (``ceil(a)``), ascending (one
    argsort-split instead of one full scan per populated slot)."""
    slots = arrival_slots(task_set).astype(np.int64)
    order = np.argsort(slots, kind="stable")
    uniq, first = np.unique(slots[order], return_index=True)
    bounds_ = np.append(first, order.size)
    return [(int(s), order[a:b])
            for s, a, b in zip(uniq, bounds_[:-1], bounds_[1:])]


def online_configs(task_set: TaskSet, mcs, use_dvfs: bool = True,
                   interval: ScalingInterval = dvfs.WIDE,
                   use_kernel: bool = False,
                   dedup: bool = True, device=None) -> List[TaskConfig]:
    """Algorithm 1 (Alg 5, lines 1-4) for the WHOLE horizon and EVERY class
    in one batch: the per-task window ``d - ceil(a)`` is fixed by the
    arrival slot, so nothing forces a per-slot solve.  With
    ``use_kernel=True`` this is a single widened kernel launch covering all
    classes.  Exposed so benchmarks can time the solve and the simulation
    separately (pass the result back through ``schedule_online(cfgs=...)``).
    Solves on ``device`` (``None`` = the CUDA card).
    """
    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)
    deadline = np.asarray(task_set.deadline, dtype=np.float64)
    allowed = deadline - arrival_slots(task_set)
    if use_dvfs:
        return machines.configure_classes(task_set.params, allowed, mcs,
                                          interval, use_kernel=use_kernel,
                                          dedup=dedup, device=device)
    return machines.default_configs(task_set, mcs, allowed=allowed)


# The pipelined driver below runs with a solve batch in flight.  Host<->
# device sync points are confined to methods whose name ends in ``_sync``;
# the ``async-protocol`` lint family derives the in-flight window from the
# dispatch sites by dataflow and flags any other blocking call
# (a host copy of a device tensor) inside it.  Every AsyncSolve handle is
# consumed exactly once, and the full-horizon views are read only after
# their chunk's sync point.

#: Target chunk size (tasks) for the pipelined driver: whole arrival groups
#: are accumulated until the count reaches this.  Large enough that one
#: batched solve amortizes its dispatch and per-chunk host bookkeeping
#: (eager op dispatch overhead is per chunk, not per row), small enough
#: that a 1M-task horizon still pipelines ~30 chunks deep.
PIPELINE_CHUNK_TASKS = 32768


def _chunk_groups(groups, target: int):
    """Cut the (slot, idx) arrival groups into consecutive runs of >=
    ``target`` tasks (always whole groups; the tail run may be smaller)."""
    chunks, cur, count = [], [], 0
    for g in groups:
        cur.append(g)
        count += g[1].size
        if count >= target:
            chunks.append(cur)
            cur, count = [], 0
    if cur:
        chunks.append(cur)
    return chunks


class _PipelineState:
    """The config-prefetch half of the pipelined driver.

    Owns the full-horizon per-class config arrays the rest of the run reads
    (:class:`~repro_torch.core.single_task.TaskConfig` views created once, so the
    :class:`~repro_torch.core.placement.PlacementContext` holds live aliases), the
    class-preference matrix, and the per-class ``t_min`` floors computed
    once up front (``dvfs.min_time`` is elementwise, so whole-horizon floors
    sliced per chunk are bitwise equal to per-call floors).

    :meth:`dispatch` sends one chunk's Algorithm-1 batch through
    :func:`repro_torch.core.machines.configure_classes_async` (same keys, tags and
    batch shapes as the synchronous :func:`online_configs`, so the solve
    cache composes across both paths); :meth:`consume_sync` — the ONE sync
    point — blocks on the in-flight rows and scatters the assembled config
    columns into the horizon arrays.
    """

    def __init__(self, task_set: TaskSet, mcs, interval: ScalingInterval,
                 allowed: np.ndarray, use_kernel: bool, dedup: bool, device):
        self.mcs = mcs
        self.interval = interval
        self.use_kernel = use_kernel
        self.dedup = dedup
        self.device = device
        self.params = task_set.params
        # Setup-time host-array normalization — no solve is in flight yet
        # (astype(copy=False) is a no-op view on the float64 input).
        self.allowed = allowed.astype(np.float64, copy=False)
        n = self.allowed.shape[0]
        self.adapted = [mc.adapt(self.params) for mc in mcs]
        self.ivs = [mc.effective_interval(interval) for mc in mcs]
        self.tmin = self._floors_sync()
        # Full-horizon config columns, filled chunk by chunk.  f64 storage:
        # every consumer (precompute casts, make_assignment floats, list
        # mirrors) upcasts the solver's f32 values anyway, and f32 -> f64 is
        # exact, so the scattered values read back bit-identically.
        self.cfgs = [TaskConfig(
            v=np.zeros(n), fc=np.zeros(n), fm=np.zeros(n),
            t_hat=np.zeros(n), p_hat=np.zeros(n), e_hat=np.zeros(n),
            t_min=np.zeros(n), deadline_prior=np.zeros(n, dtype=bool),
            feasible=np.zeros(n, dtype=bool), n_deadline_prior=0)
            for _ in mcs]
        self.order_cls = np.zeros((len(mcs), n), dtype=np.int64)

    def _floors_sync(self) -> list:
        """Whole-horizon ``t_min`` per class, one blocking solve at setup
        (before anything is in flight)."""
        return [np.asarray(dvfs.min_time(a, iv), np.float64)
                for a, iv in zip(self.adapted, self.ivs)]

    def dispatch(self, idx: np.ndarray):
        """Send one chunk's all-classes solve; returns the in-flight handle
        (``machines.ClassSolves``).  ``adapt`` is elementwise, so adapting
        the chunk subset equals slicing the adapted horizon, bitwise."""
        return machines.configure_classes_async(
            self.params[idx], self.allowed[idx], self.mcs, self.interval,
            use_kernel=self.use_kernel, dedup=self.dedup, device=self.device)

    def consume_sync(self, handle, idx: np.ndarray):
        """Block on one chunk's rows and scatter the assembled configs into
        the horizon arrays (+ the chunk's class-preference columns —
        ``argsort(axis=0)`` is per-column independent, so chunk columns
        equal the monolithic ``machines.class_order`` sliced)."""
        from repro_torch.core import solver_cache

        allowed = self.allowed[idx]
        for c, rows in enumerate(handle.result()):
            sol = solver_cache.rows_to_solution(rows)
            cfg = single_task.config_from_solution(
                sol, self.adapted[c], allowed, self.ivs[c],
                tmin=self.tmin[c][idx])
            dst = self.cfgs[c]
            dst.v[idx] = cfg.v
            dst.fc[idx] = cfg.fc
            dst.fm[idx] = cfg.fm
            dst.t_hat[idx] = cfg.t_hat
            dst.p_hat[idx] = cfg.p_hat
            dst.e_hat[idx] = cfg.e_hat
            dst.t_min[idx] = cfg.t_min
            dst.deadline_prior[idx] = cfg.deadline_prior
            dst.feasible[idx] = cfg.feasible
        if len(self.mcs) > 1:
            e = np.stack([c.e_hat[idx] for c in self.cfgs])
            feas = np.stack([c.feasible[idx] for c in self.cfgs])
            key = np.where(feas, e, e + machines.INFEASIBLE_PENALTY)
            self.order_cls[:, idx] = np.argsort(key, axis=0, kind="stable")


class _ReadjustPrefetch:
    """The θ-readjustment half of the pipeline: at every chunk boundary the
    rows queued since the last boundary are dispatched per class
    (deadline-boundary solves, same keys/tags as
    :func:`repro_torch.core.single_task.readjust_batch`), joining the in-flight
    work instead of the run-end batch; :meth:`flush_sync` materializes every
    batch and writes the records back exactly like
    :func:`repro_torch.core.scheduling.fill_readjusted`.

    A readjusted window only pins the task's finish time — never the
    packing — and the solve values depend only on (task params, window,
    class), all fixed at queue time, so host-state changes (placements,
    power-offs, fault injection) between dispatch and flush cannot change
    the values.  Pair failures only *invalidate pools* (epoch bump), never
    prefetched solves.
    """

    def __init__(self, task_set: TaskSet, mcs, interval: ScalingInterval,
                 use_kernel: bool, dedup: bool, device):
        self.params = task_set.params
        self.mcs = mcs
        self.interval = interval
        self.use_kernel = use_kernel
        self.dedup = dedup
        self.device = device
        self.sent = 0
        self.batches: list = []   # (assignment idx, windows, AsyncSolve)

    def dispatch(self, pending: List[PendingRow]):
        """Send every pending row queued since the last call, one boundary
        batch per class present."""
        new = pending[self.sent:]
        if not new:
            return
        self.sent = len(pending)
        k = len(new)
        ai = np.fromiter((r[0] for r in new), np.int64, k)
        rows = np.fromiter((r[1] for r in new), np.int64, k)
        windows = np.fromiter((r[2] for r in new), np.float64, k)
        cids = np.fromiter((r[3] for r in new), np.int64, k)
        for cid in np.unique(cids):
            mc = self.mcs[int(cid)]
            m = cids == cid
            handle = single_task.solve_rows_async(
                mc.adapt(self.params[rows[m]]), windows[m],
                mc.effective_interval(self.interval), boundary=True,
                use_kernel=self.use_kernel, dedup=self.dedup,
                device=self.device)
            self.batches.append((ai[m], windows[m], handle))

    def flush_sync(self, assignments: List[cl.Assignment],
                   pending: List[PendingRow]):
        """Dispatch the tail rows, block on every batch and write the DVFS
        fields back (the pipelined :func:`fill_readjusted`)."""
        self.dispatch(pending)
        for ai, windows, handle in self.batches:
            rows = handle.result()
            v = rows[:, layout.SOL_V].astype(np.float64)
            fc = rows[:, layout.SOL_FC].astype(np.float64)
            fm = rows[:, layout.SOL_FM].astype(np.float64)
            t = rows[:, layout.SOL_T].astype(np.float64)
            p = rows[:, layout.SOL_P].astype(np.float64)
            feas = rows[:, layout.SOL_FEASIBLE] > 0.5
            t = np.where(feas, np.minimum(t, windows), t)  # snap f32 residual
            e = p * t
            for j, a_i in enumerate(ai.tolist()):
                a = assignments[a_i]
                assignments[a_i] = dataclasses.replace(
                    a, v=float(v[j]), fc=float(fc[j]), fm=float(fm[j]),
                    power=float(p[j]), energy=float(e[j]))
        self.batches = []


def _chunk_span(ch):
    """One chunk's task index set: a contiguous ``slice`` when the indices
    form an unbroken run (always, for the slot-sorted traces
    ``tasks.generate_trace`` emits — then every per-chunk gather is a
    view), the concatenated index array otherwise."""
    cat = np.concatenate([idx for _, idx in ch])
    lo, hi = int(cat[0]), int(cat[-1]) + 1
    if hi - lo == cat.shape[0] and np.array_equal(
            cat, np.arange(lo, hi, dtype=cat.dtype)):
        return slice(lo, hi)
    return cat


def _drive_pipelined(groups, state: Optional[_PipelineState],
                     readj: _ReadjustPrefetch, ctx: PlacementContext,
                     pending: List[PendingRow], place_group, vector: bool,
                     prep: bool = False):
    """The double-buffered driver loop: with chunk ``k``'s configs landed,
    dispatch chunk ``k+1``'s solve and the readjustment rows queued so far,
    THEN place chunk ``k`` — the device computes ahead while the host
    packs.  ``state is None`` (configs injected / DVFS off) degenerates to
    chunked placement with the readjustment prefetch only.  ``prep``
    (worst-fit vector placement only) additionally hoists each group's
    placement prologue into one vectorized
    :meth:`~repro_torch.core.placement.PlacementContext.prepare_chunk` pass."""
    chunks = _chunk_groups(groups, PIPELINE_CHUNK_TASKS)
    spans = [_chunk_span(ch) for ch in chunks]
    handle = state.dispatch(spans[0]) if state is not None and chunks else None
    for j, ch in enumerate(chunks):
        if state is not None:
            nxt = state.dispatch(spans[j + 1]) if j + 1 < len(chunks) else None
            state.consume_sync(handle, spans[j])
            if vector:
                ctx.update_tasks(spans[j])
            handle = nxt
        readj.dispatch(pending)
        if prep:
            for (slot, idx), pr in zip(ch, ctx.prepare_chunk(ch)):
                place_group(slot, idx, pr)
        else:
            for slot, idx in ch:
                place_group(slot, idx)


def schedule_online(task_set: TaskSet, l: int = 1, theta: float = 1.0,
                    algorithm: str = "edl", use_dvfs: bool = True,
                    interval: ScalingInterval = dvfs.WIDE,
                    rho: int = cl.RHO, p_idle: float = cl.P_IDLE,
                    delta_on: float = cl.DELTA_ON,
                    use_kernel: bool = False,
                    classes=None, placement: str = "vector",
                    cfgs: Optional[List[TaskConfig]] = None,
                    bound: bool = True,
                    dedup: bool = True,
                    faults: Optional[FaultTrace] = None,
                    pipeline: bool = True, device=None) -> cl.ScheduleResult:
    """Run the online simulation end to end (Algorithms 4-6).

    ``algorithm`` is ``"edl"`` (Algorithm 5, SPT + theta-readjustment) or
    ``"bin"`` (Algorithm 6, worst-fit utilization for the offline batch then
    first-fit online).  ``classes`` selects the machine-class mix (``None``
    = the homogeneous paper setup with the scalar ``p_idle``/``delta_on``;
    with a mix, idle power and turn-on overhead come from each class).
    ``placement`` picks the group-batched array path (``"vector"``, default)
    or the per-task reference loop (``"scalar"``); both produce bit-identical
    schedules.  ``cfgs`` injects precomputed :func:`online_configs` output
    (must match ``task_set``/``classes``/``use_dvfs``/``interval``).
    ``bound=False`` skips the ``e_bound`` solve (benchmarks timing the
    simulation hot path).  ``dedup=False`` opts every DVFS solve out of the
    unique-row dedup + solve cache (the default routes them through it,
    bit-identically).

    ``faults`` injects a :class:`repro_torch.core.faults.FaultTrace`: every
    fail/revive event with ``t <= slot`` is applied — energy settled at the
    exact event time — before the slot's arrival group is placed, orphaned
    tasks re-enter placement with shrunken DVFS windows, and the result
    carries ``fault_stats``.  ``faults=None`` (default) leaves every
    failure check disengaged, bit-identical to the pre-fault behaviour.

    ``pipeline=True`` (default) overlaps the DVFS solve batches with the
    host placement (async chunked config prefetch + deferred readjustment
    batches joining the in-flight work + persistent candidate pools on the
    vector path) — bit-identical to ``pipeline=False``, the synchronous
    reference path.

    Every solve runs on ``device`` (``None`` = the CUDA card; it raises
    without one; ``"cpu"`` runs the plain torch versions on the host).
    """
    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)
    algorithm = algorithm.lower()
    if algorithm not in ("edl", "bin"):
        raise ValueError(f"unknown online algorithm {algorithm!r}")
    if placement not in ("vector", "scalar"):
        raise ValueError(f"unknown placement mode {placement!r}")
    mcs = machines.resolve_classes(classes, p_idle=p_idle, delta_on=delta_on)

    n = len(task_set)
    deadline = np.asarray(task_set.deadline, dtype=np.float64)

    from repro_torch.core import solver_cache
    if dedup:
        # Per-run counters (reported as ``result.cache_stats``); the cached
        # rows themselves persist across runs.
        solver_cache.GLOBAL_CACHE.reset_stats()

    groups = _slot_groups(task_set)

    prefetch = pipeline and cfgs is None and use_dvfs and n > 0
    state: Optional[_PipelineState] = None
    if prefetch:
        allowed = deadline - arrival_slots(task_set)
        state = _PipelineState(task_set, mcs, interval, allowed,
                               use_kernel, dedup, device)
        cfgs = state.cfgs               # live views, filled chunk by chunk
        order_cls = state.order_cls
    else:
        if cfgs is None:
            cfgs = online_configs(task_set, mcs, use_dvfs=use_dvfs,
                                  interval=interval, use_kernel=use_kernel,
                                  dedup=dedup, device=device)
        order_cls = machines.class_order(cfgs)      # [C, n]

    eng = ClusterEngine(l, servers=True, rho=rho, classes=mcs)
    assignments: List[cl.Assignment] = []
    pending: List[PendingRow] = []
    ctx = PlacementContext(eng, cfgs, deadline, theta=theta,
                           readjust=(algorithm == "edl"),
                           assignments=assignments, pending=pending,
                           order_cls=order_cls,
                           incremental=(pipeline and placement == "vector"))

    injector = None
    if faults is not None:
        injector = FaultInjector(
            eng, ctx, faults, rule=("wf" if algorithm == "edl" else "ff"),
            degrade=make_degrade(task_set, mcs, interval, use_dvfs))

    def place_group(slot: int, idx: np.ndarray, prep=None):
        t_now = float(slot)
        if injector is not None:
            # Apply every failure/recovery event up to this slot, each
            # settled at its exact time, BEFORE placing the slot's arrivals.
            injector.advance(t_now)
        eng.settle(t_now)

        # EDF order — precomputed chunk-wide when ``prep`` is injected.
        order = None if prep is not None \
            else np.argsort(deadline[idx], kind="stable")

        base = len(assignments)
        if algorithm == "bin" and slot == 0:
            # Algorithm 6 offline phase: worst-fit on task utilization.
            ctx.binpack_offline_util(idx, order, t_now)
        elif placement == "vector":
            if algorithm == "bin":
                ctx.place_group_select(idx, order, t_now, "ff")
            else:
                ctx.place_group_vector(idx, order, t_now, prep=prep)
        else:
            ctx.place_group_scalar(idx, order, t_now,
                                   "wf" if algorithm == "edl" else "ff")
        if injector is not None:
            injector.register(base)

    if pipeline:
        readj = _ReadjustPrefetch(task_set, mcs, interval, use_kernel, dedup,
                                  device)
        _drive_pipelined(groups, state, readj, ctx, pending, place_group,
                         vector=(placement == "vector"),
                         prep=(placement == "vector" and algorithm == "edl"))
        if injector is not None:
            injector.advance(np.inf)   # events after the last arrival slot
        # Materialize the in-flight readjustment batches + the tail rows.
        readj.flush_sync(assignments, pending)
    else:
        for slot, idx in groups:
            place_group(slot, idx)
        if injector is not None:
            injector.advance(np.inf)   # events after the last arrival slot
        # Deferred theta-readjustment solves: one batched dispatch per class.
        fill_readjusted(assignments, pending, task_set, interval, use_kernel,
                        mcs, dedup=dedup, device=device)
    if injector is not None:
        injector.finalize_records()    # re-price truncated records

    # Per-run solve-cache counters: the config + readjustment solves (the
    # e_bound solve below is not part of the scheduling hot path).
    cache_stats = solver_cache.GLOBAL_CACHE.stats() if dedup else None

    e_idle, e_overhead, n_servers = eng.finalize()
    e_run = float(sum(a.energy for a in assignments))
    violations = count_violations(
        assignments, deadline, chosen_feasibility(cfgs, assignments, n))
    mk = max((a.finish for a in assignments), default=0.0)
    e_bound = bounds.theoretical_bound(
        task_set, interval=interval, classes=mcs, l=l,
        rho=rho, dedup=dedup, device=device).e_bound if bound else 0.0
    return cl.ScheduleResult(
        algorithm=f"online-{algorithm}{'+dvfs' if use_dvfs else ''}",
        e_run=e_run, e_idle=e_idle, e_overhead=e_overhead,
        n_pairs=eng.n_pairs, n_servers=n_servers,
        violations=violations, assignments=assignments, makespan=mk,
        feasible_pairs=eng.feasible_pairs, e_bound=e_bound,
        fault_stats=dict(injector.stats) if injector is not None else None,
        cache_stats=cache_stats,
    )
