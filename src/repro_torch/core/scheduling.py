"""Offline scheduling: the EDL theta-readjustment algorithm and baselines
(paper S4.2.1, Algorithms 1-3; baselines of S5.3).

All offline algorithms share the same three-phase structure:

1. **Algorithm 1** - per-task optimal DVFS configuration (deadline-aware),
   one batched solve for the whole task set (the CUDA kernel with
   ``use_kernel=True``); deadline-prior tasks get the boundary solution,
   energy-prior tasks get the unconstrained optimum.  With heterogeneous
   machine classes (``classes=...``) the solve runs once per task **per
   class** — a single widened kernel dispatch — and each task's classes are
   ranked min-energy-feasible first (:func:`repro_torch.core.machines.class_order`).
2. **Task packing** - deadline-prior tasks are pinned to fresh pairs first
   (they must start at t=0), then the energy-prior tasks are placed in EDF
   order by the policy-specific rule, each a path of the shared placement
   subsystem (:mod:`repro_torch.core.placement`) over the
   :class:`~repro_torch.core.engine.ClusterEngine` pair arrays, applied to each
   candidate class in preference order:

   * ``edl``    - shortest-processing-time pair (worst fit) **with
     theta-readjustment**: if the task does not fit at its optimal length, its
     execution is allowed to shrink to ``max(theta * t_hat, t_min)`` by
     re-solving the DVFS setting with the remaining window as deadline
     (Algorithm 2, lines 16-19).  The re-solves only pin the finish time to
     the window during packing; the actual DVFS settings/energies are
     batch-solved afterwards (`single_task.readjust_batch`, one dispatch per
     class present).
   * ``edf-wf`` - worst fit (min mu), no readjustment;
   * ``edf-bf`` - best fit (max mu among fitting pairs), no readjustment;
   * ``lpt-ff`` - longest-processing-time order, first fit, no readjustment.

   A task no class can host lands on a fresh pair of its primary
   (min-energy feasible) class.

   The offline batch is the placement subsystem's degenerate "one group at
   ``t = 0``" case: ``placement="vector"`` (default) runs the batched
   worst-fit frontier / pooled probes of
   :class:`~repro_torch.core.placement.PlacementContext`,
   ``placement="scalar"`` the per-task reference loop over the engine
   selectors — bit-identical by construction
   (``tests/test_placement.py`` pins all four policies).

3. **Algorithm 3** - the engine finalizer groups pairs into virtual servers
   of ``l`` per class; idle energy is ``P_idle * sum_j sum_k (F_j - tau_kj)``
   (Eq. 6) with the class's own ``P_idle``.

Every result also reports ``e_bound``, the §5 analytical lower bound on
its energy (:func:`repro_torch.core.bounds.theoretical_bound`), so achieved
savings can be read against the paper's ~36% ceiling.

See docs/EQUATIONS.md for the full equation/algorithm -> code map.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import bounds, cluster as cl, dvfs, machines, single_task
from repro_torch.core.dvfs import ScalingInterval
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.machines import MachineClass, resolve_classes
from repro_torch.core.placement import (OFFLINE_RULES, PendingRow, PlacementContext,
                                  make_assignment)
from repro_torch.core.single_task import TaskConfig
from repro_torch.core.tasks import TaskSet

_EPS = 1e-9


def default_config(task_set: TaskSet) -> TaskConfig:
    """A no-DVFS configuration: every task runs at (1, 1, 1) (the shared
    :func:`repro_torch.core.single_task.no_dvfs_config` on the reference fit)."""
    return single_task.no_dvfs_config(task_set.params,
                                      task_set.deadline - task_set.arrival)


def configure(task_set: TaskSet, use_dvfs: bool,
              interval: ScalingInterval = dvfs.WIDE,
              use_kernel: bool = False, dedup: bool = True,
              device=None) -> TaskConfig:
    """Algorithm 1 over a task set (or the no-DVFS default configuration)."""
    if not use_dvfs:
        return default_config(task_set)
    allowed = task_set.deadline - task_set.arrival
    return single_task.configure_tasks(task_set.params, allowed, interval,
                                       use_kernel=use_kernel, dedup=dedup,
                                       device=device)


def configure_all(task_set: TaskSet, use_dvfs: bool,
                  mcs: Sequence[MachineClass],
                  interval: ScalingInterval = dvfs.WIDE,
                  use_kernel: bool = False, dedup: bool = True,
                  device=None) -> List[TaskConfig]:
    """Algorithm 1 on every class (offline windows ``d - a``)."""
    if not use_dvfs:
        return machines.default_configs(task_set, mcs)
    allowed = task_set.deadline - task_set.arrival
    return machines.configure_classes(task_set.params, allowed, mcs,
                                      interval, use_kernel=use_kernel,
                                      dedup=dedup, device=device)


def fill_readjusted(assignments: List[cl.Assignment],
                    pending: List[PendingRow],
                    task_set: TaskSet, interval: ScalingInterval,
                    use_kernel: bool, mcs: Sequence[MachineClass],
                    dedup: bool = True, device=None):
    """Solve every deferred theta-readjustment in one batched dispatch per
    class present and write the DVFS settings/energies back into the
    assignment list.

    ``pending`` rows are ``(assignment_index, task_index, window, class_id)``.
    The schedule itself never depends on these solves — a readjusted task
    always occupies exactly its window — so they are batched after packing:
    one kernel launch (or one grid+golden boundary solve) per class instead
    of one scalar dispatch per readjusted task.
    """
    if not pending:
        return
    rows = np.asarray([t for _, t, _, _ in pending], dtype=np.int64)
    windows = np.asarray([w for _, _, w, _ in pending], dtype=np.float64)
    cids = np.asarray([c for _, _, _, c in pending], dtype=np.int64)
    v, fc, fm, t, p, e = machines.readjust_classes(
        task_set.params, rows, windows, cids, mcs, interval, use_kernel,
        dedup=dedup, device=device)
    for k, (ai, _, _, _) in enumerate(pending):
        a = assignments[ai]
        assignments[ai] = dataclasses.replace(
            a, v=float(v[k]), fc=float(fc[k]), fm=float(fm[k]),
            power=float(p[k]), energy=float(e[k]))


def count_violations(assignments: List[cl.Assignment], deadline: np.ndarray,
                     feasible: np.ndarray) -> int:
    """Each violated task counts exactly once: infeasible at configuration
    time (cannot meet its deadline at max speed) OR finished past its
    deadline — never both.  Records truncated by a server failure are
    skipped: the task is judged by its re-placed record (every task keeps
    exactly one live record under fault injection)."""
    violated = ~np.asarray(feasible, dtype=bool)
    if assignments:
        t = np.fromiter((a.task for a in assignments if not a.failed),
                        np.int64)
        f = np.fromiter((a.finish for a in assignments if not a.failed),
                        np.float64)
        violated[t[f > deadline[t] + 1e-6]] = True
    return int(np.sum(violated))


def chosen_feasibility(cfgs: Sequence[TaskConfig],
                       assignments: List[cl.Assignment],
                       n_tasks: int) -> np.ndarray:
    """Per-task feasibility on the class each task actually ran on (for a
    task re-placed after a server failure: the class of its live record —
    failed records are skipped)."""
    feas = np.ones(n_tasks, dtype=bool)
    if not assignments:
        return feas
    t = np.fromiter((a.task for a in assignments if not a.failed), np.int64)
    if len(cfgs) == 1:
        feas[t] = np.asarray(cfgs[0].feasible, bool)[t]
        return feas
    cid = np.fromiter((a.class_id for a in assignments if not a.failed),
                      np.int64)
    for c in np.unique(cid):
        tc = t[cid == c]
        feas[tc] = np.asarray(cfgs[int(c)].feasible, bool)[tc]
    return feas


def schedule_offline(task_set: TaskSet, l: int = 1, theta: float = 1.0,
                     algorithm: str = "edl", use_dvfs: bool = True,
                     interval: ScalingInterval = dvfs.WIDE,
                     p_idle: float = cl.P_IDLE,
                     cfg: Optional[TaskConfig] = None,
                     use_kernel: bool = False,
                     classes=None, placement: str = "vector",
                     cfgs: Optional[List[TaskConfig]] = None,
                     bound: bool = True,
                     dedup: bool = True, device=None) -> cl.ScheduleResult:
    """Run one offline scheduling algorithm end to end (Algorithms 1+2+3).

    ``classes`` selects the machine-class mix: ``None`` is the homogeneous
    paper setup (one reference class — identical to the pre-heterogeneity
    code path), otherwise a sequence of registry names and/or
    :class:`~repro_torch.core.machines.MachineClass` instances.  ``cfg`` (a
    precomputed single-class Algorithm-1 output) is only valid for the
    homogeneous case; ``cfgs`` injects the full per-class
    :func:`configure_all` output (must match ``task_set``/``classes``/
    ``use_dvfs``/``interval``).  ``placement`` picks the batched array path
    (``"vector"``, default) or the per-task reference loop (``"scalar"``);
    both produce bit-identical schedules.  ``bound=False`` skips the
    ``e_bound`` solve (benchmarks timing the packing hot path).
    ``dedup=False`` opts every DVFS solve out of the unique-row dedup +
    solve cache (the default routes them through it, bit-identically).
    Every solve runs on ``device`` (``None`` = the CUDA card; it raises
    without one).
    """
    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)
    algorithm = algorithm.lower()
    if algorithm not in OFFLINE_RULES:
        raise ValueError(f"unknown offline algorithm {algorithm!r}")
    if placement not in ("vector", "scalar"):
        raise ValueError(f"unknown placement mode {placement!r}")
    mcs = resolve_classes(classes, p_idle=p_idle)
    if cfg is not None:
        if len(mcs) > 1:
            raise ValueError("cfg= is only supported for a single class")
        cfgs = [cfg]
    elif cfgs is None:
        cfgs = configure_all(task_set, use_dvfs, mcs, interval,
                             use_kernel=use_kernel, dedup=dedup, device=device)
    elif len(cfgs) != len(mcs):
        raise ValueError("cfgs= needs one TaskConfig per machine class")

    n = len(task_set)
    deadline = np.asarray(task_set.deadline, dtype=np.float64)
    order_cls = machines.class_order(cfgs)          # [C, n]
    primary = order_cls[0]
    assignments: List[cl.Assignment] = []
    pending: List[PendingRow] = []
    eng = ClusterEngine(l, servers=False, classes=mcs)
    ctx = PlacementContext(eng, cfgs, deadline, theta=theta,
                           readjust=(algorithm == "edl"),
                           assignments=assignments, pending=pending,
                           order_cls=order_cls)

    # --- Phase 2a: tasks that are deadline-prior on their primary class,
    # each started at t=0 on a fresh pair of that class.
    dp_primary = np.take_along_axis(
        np.stack([np.asarray(c.deadline_prior, bool) for c in cfgs]),
        primary[None], axis=0)[0]
    dp_idx = np.nonzero(dp_primary)[0]
    dp_order = dp_idx[np.argsort(deadline[dp_idx], kind="stable")]
    if placement == "vector":
        ctx.pin_fresh(dp_order)
    else:
        for t_idx in dp_order:
            t_idx = int(t_idx)
            c = int(primary[t_idx])
            pid = eng.open_pair(class_id=c)
            eng.assign(pid, 0.0, float(cfgs[c].t_hat[t_idx]))
            assignments.append(make_assignment(t_idx, pid, 0.0, cfgs[c],
                                               class_id=c))

    # --- Phase 2b: energy-prior tasks by the policy rule, trying classes in
    # min-energy-feasible-first order — ONE group at t=0 through the shared
    # placement subsystem.
    ep_idx = np.nonzero(~dp_primary)[0]
    if algorithm == "lpt-ff":
        t_hat_primary = np.take_along_axis(
            np.stack([np.asarray(c.t_hat) for c in cfgs]),
            primary[None], axis=0)[0]
        order = ep_idx[np.argsort(-t_hat_primary[ep_idx], kind="stable")]
    else:
        order = ep_idx[np.argsort(deadline[ep_idx], kind="stable")]

    rule = OFFLINE_RULES[algorithm]
    pos = np.arange(order.shape[0])
    if placement == "vector":
        if rule == "wf":
            ctx.place_group_vector(order, pos, 0.0)
        else:
            ctx.place_group_select(order, pos, 0.0, rule)
    else:
        ctx.place_group_scalar(order, pos, 0.0, rule)

    # --- Deferred theta-readjustment solves: one batched dispatch per class.
    fill_readjusted(assignments, pending, task_set, interval, use_kernel, mcs,
                    dedup=dedup, device=device)

    # --- Phase 3: Algorithm 3 server grouping + Eq. (6) energies per class.
    e_run = float(sum(a.energy for a in assignments))
    e_idle, e_overhead, n_servers = eng.finalize()
    violations = count_violations(
        assignments, deadline, chosen_feasibility(cfgs, assignments, n))
    e_bound = bounds.theoretical_bound(
        task_set, interval=interval, classes=mcs,
        dedup=dedup, device=device).e_bound if bound else 0.0
    return cl.ScheduleResult(
        algorithm=f"{algorithm}{'+dvfs' if use_dvfs else ''}",
        e_run=e_run, e_idle=e_idle, e_overhead=e_overhead,
        n_pairs=eng.n_pairs, n_servers=n_servers, violations=violations,
        assignments=assignments,
        makespan=float(eng.mu.max()) if eng.n_pairs else 0.0,
        feasible_pairs=eng.feasible_pairs, e_bound=e_bound,
    )
