"""Heterogeneous machine classes: the per-pair-class layer of the cluster.

The paper's premise is a *heterogeneous* CPU-GPU cluster — pairs whose
accelerators have different power/frequency curves.  A
:class:`MachineClass` captures one device class as a transform of the
canonical GTX-1080Ti-fit task parameters (:mod:`repro_torch.core.tasks`) plus its
own DVFS scaling box:

* ``speed``        — relative throughput: both time components (``D``,
                     ``t0``) are divided by it;
* ``power_scale``  — power envelope relative to the reference part;
* ``p0_frac`` / ``gamma_frac`` — optional re-split of the scaled default
                     power ``P*`` into static / memory / core shares (the
                     way :func:`repro_torch.core.dvfs.tpu_task_params` derives a
                     chip's split from its envelope);
* ``interval``     — the class's own :class:`~repro_torch.core.dvfs.ScalingInterval`
                     (``None`` = follow the run-level interval, the
                     reference-class behaviour);
* ``p_idle`` / ``delta_on`` — per-class idle power and turn-on overhead
                     used by the :class:`~repro_torch.core.engine.ClusterEngine`
                     finalizers (Eq. 6/7 per class).

The **reference class** (``gtx-1080ti``) is the identity transform: with a
single reference class every scheduler degenerates bit-for-bit to the
homogeneous code path (pinned by ``tests/test_machines.py`` against the
``tests/test_engine.py`` goldens).

:func:`configure_classes` runs Algorithm 1 for every task **on every
class**: with ``use_kernel=True`` all ``C x n`` solves go through ONE
widened ``[C*n, 16]`` kernel launch whose rows carry their own interval
bounds (``layout.BOUNDS_SLICE``, see :mod:`repro_torch.kernels.layout`);
otherwise one batched grid+golden solve per class.  Both run on the
``device`` the caller names (``None`` = the CUDA card).  The schedulers
then pick, per task, the min-energy *feasible* class first and fall back
through the remaining classes in ascending energy order (see
docs/EQUATIONS.md for the equation/algorithm map).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import cluster as cl, dvfs, single_task
from repro_torch.core.dvfs import DvfsParams, ScalingInterval
from repro_torch.core.single_task import TaskConfig
from repro_torch.kernels import layout

_EPS = 1e-9
INFEASIBLE_PENALTY = 1e30  # pushes infeasible classes behind feasible ones


@dataclasses.dataclass(frozen=True)
class MachineClass:
    """One accelerator pair class: a parameter transform + a DVFS box."""

    name: str
    interval: Optional[ScalingInterval] = None  # None -> run-level interval
    speed: float = 1.0
    power_scale: float = 1.0
    p0_frac: Optional[float] = None
    gamma_frac: Optional[float] = None
    p_idle: float = cl.P_IDLE
    delta_on: float = cl.DELTA_ON

    @property
    def is_reference(self) -> bool:
        """True if :meth:`adapt` is the identity transform."""
        return (self.speed == 1.0 and self.power_scale == 1.0
                and self.p0_frac is None and self.gamma_frac is None)

    def effective_interval(self, default: ScalingInterval) -> ScalingInterval:
        return self.interval if self.interval is not None else default

    def adapt(self, params: DvfsParams) -> DvfsParams:
        """Class-specific task constants from the reference (1080Ti) fit.

        The identity class returns values bit-identical to its input
        (``x * 1.0`` and ``x / 1.0`` are exact in IEEE-754), which is what
        lets a single-reference-class run reproduce the homogeneous goldens
        exactly.
        """
        p0, gamma, c, big_d, delta, t0 = (
            np.asarray(f, np.float64) for f in params.astuple())
        if self.p0_frac is not None or self.gamma_frac is not None:
            if self.p0_frac is None or self.gamma_frac is None:
                raise ValueError(f"{self.name}: p0_frac and gamma_frac must "
                                 "be set together")
            p_star = (p0 + gamma + c) * self.power_scale
            p0 = p_star * self.p0_frac
            gamma = p_star * self.gamma_frac
            c = p_star - p0 - gamma
        else:
            p0 = p0 * self.power_scale
            gamma = gamma * self.power_scale
            c = c * self.power_scale
        return DvfsParams(p0=p0, gamma=gamma, c=c, big_d=big_d / self.speed,
                          delta=delta, t0=t0 / self.speed)


# ---------------------------------------------------------------------------
# Registry (the class mixes the scenario sweep iterates over).
# ---------------------------------------------------------------------------

#: Reference power envelope (W): mid of the paper's fitted P* range
#: [175, 206] for the GTX-1080Ti library — the denominator every other
#: class's ``power_scale`` is expressed against.
REF_P_PEAK = 190.0

#: The canonical class: the GTX-1080Ti the paper's 20-app library was fitted
#: on.  Identity transform; its interval follows the run-level choice
#: (WIDE analytic / NARROW realistic).
GTX_1080TI = MachineClass("gtx-1080ti")

#: The v5e-class accelerator from the chip envelope constants in
#: :mod:`repro_torch.core.dvfs`: ~200 W peak split 30/15/55 static/HBM/core,
#: ~35% faster per task than the reference part, with its own tighter box.
TPU_V5E = MachineClass(
    "tpu-v5e",
    interval=dvfs.TPU_V5E_INTERVAL,
    speed=1.35,
    power_scale=dvfs.TPU_V5E_CHIP["p_peak"] / REF_P_PEAK,
    p0_frac=dvfs.TPU_V5E_CHIP["p0_frac"],
    gamma_frac=dvfs.TPU_V5E_CHIP["gamma_frac"],
    p_idle=dvfs.TPU_V5E_CHIP["p_idle"],
    delta_on=dvfs.TPU_V5E_CHIP["delta_on"],
)

#: A Volta-class datacenter GPU: ~250 W envelope, ~1.5x the reference
#: throughput, a slightly wider voltage floor than the 1080Ti's NARROW box
#: (fit ranges in the style of the paper's published table).
V100_SXM2 = MachineClass(
    "v100-sxm2",
    interval=ScalingInterval(v_min=0.75, v_max=1.2, fc_min=0.55,
                             fm_min=0.65, fm_max=1.1),
    speed=1.5,
    power_scale=250.0 / REF_P_PEAK,
    p0_frac=0.35,
    gamma_frac=0.18,
    p_idle=45.0,
    delta_on=110.0,
)

REGISTRY = {c.name: c for c in (GTX_1080TI, TPU_V5E, V100_SXM2)}

ClassSpec = Union[str, MachineClass]


def get_classes(names: Sequence[ClassSpec]) -> Tuple[MachineClass, ...]:
    """Resolve a class mix: registry names and/or MachineClass instances."""
    out = []
    for item in names:
        if isinstance(item, MachineClass):
            out.append(item)
        elif item in REGISTRY:
            out.append(REGISTRY[item])
        else:
            raise KeyError(f"unknown machine class {item!r}; registry has "
                           f"{sorted(REGISTRY)}")
    if not out:
        raise ValueError("a class mix needs at least one machine class")
    return tuple(out)


def reference_classes(p_idle: float = cl.P_IDLE,
                      delta_on: float = cl.DELTA_ON) -> Tuple[MachineClass, ...]:
    """The homogeneous degenerate case: one identity class with the
    engine-scalar idle/overhead constants."""
    return (MachineClass("default", p_idle=p_idle, delta_on=delta_on),)


def resolve_classes(classes, p_idle: float = cl.P_IDLE,
                    delta_on: float = cl.DELTA_ON) -> Tuple[MachineClass, ...]:
    """Class-mix argument -> MachineClass tuple: ``None`` is the homogeneous
    default (one identity class with the given scalar constants), anything
    else a sequence of registry names and/or instances.  The ONE resolver
    shared by both schedulers and :mod:`repro_torch.core.bounds`."""
    if classes is None:
        return reference_classes(p_idle=p_idle, delta_on=delta_on)
    return get_classes(classes)


# ---------------------------------------------------------------------------
# Algorithm 1 across classes.
# ---------------------------------------------------------------------------


def configure_classes(params: DvfsParams, allowed: np.ndarray,
                      classes: Sequence[MachineClass],
                      interval: ScalingInterval = dvfs.WIDE,
                      use_kernel: bool = False,
                      dedup: bool = True, device=None) -> List[TaskConfig]:
    """Algorithm 1 for every task on every class: ``C`` TaskConfigs of ``n``.

    ``use_kernel=True`` fuses all ``C x n`` solves into ONE widened kernel
    launch — the class blocks are stacked into a ``[C*n, 16]`` task matrix
    whose rows carry their class's interval bounds.  The grid+golden path
    runs one batched ``configure_tasks`` per class.
    ``dedup=True`` (default) routes either path through the unique-row
    dedup + process-wide solve cache (bit-identical; see
    :mod:`repro_torch.core.solver_cache`).
    """
    from repro_torch.kernels import ops as kernel_ops

    device = kernel_ops.resolve_device(device)
    allowed = np.asarray(allowed, dtype=np.float64)
    if not use_kernel:
        return [single_task.configure_tasks(
                    mc.adapt(params), allowed, mc.effective_interval(interval),
                    use_kernel=False, dedup=dedup, device=device)
                for mc in classes]

    n = allowed.shape[0]
    adapted = [mc.adapt(params) for mc in classes]
    ivs = [mc.effective_interval(interval) for mc in classes]
    big = DvfsParams(*(np.concatenate([np.asarray(f, np.float64)
                                       for f in cols])
                       for cols in zip(*(a.astuple() for a in adapted))))
    allowed_rep = np.tile(allowed, len(classes))
    interval_rows = np.concatenate(
        [np.broadcast_to(np.asarray(iv.bounds(), np.float64),
                         (n, layout.N_BOUNDS))
         for iv in ivs], axis=0)
    big, allowed_rep, interval_rows, _ = single_task.pad_pow2(
        big, allowed_rep, interval_rows)
    sol = kernel_ops.dvfs_solve(big, allowed_rep, interval,
                                interval_rows=interval_rows, dedup=dedup,
                                device=device)
    cfgs: List[TaskConfig] = []
    for c, (a, iv) in enumerate(zip(adapted, ivs)):
        sol_c = type(sol)(*(np.asarray(f)[c * n: (c + 1) * n] for f in sol))
        cfgs.append(single_task.config_from_solution(sol_c, a, allowed, iv))
    return cfgs


class ClassSolves:
    """In-flight Algorithm-1 solves for one chunk of tasks on every class.

    Wraps either one :class:`~repro_torch.core.solver_cache.AsyncSolve` per
    class (grid+golden path) or a single stacked-launch handle (kernel path);
    :meth:`result` blocks and returns the per-class ``[k, 8]`` solution
    rows — the same bits the synchronous :func:`configure_classes` would
    have produced for those rows.
    """

    __slots__ = ("_handles", "_stacked", "_n")

    def __init__(self, handles=None, stacked=None, n: int = 0):
        self._handles = handles
        self._stacked = stacked
        self._n = n

    def result(self) -> List[np.ndarray]:
        if self._stacked is not None:
            rows = self._stacked.result()
            n = self._n
            return [rows[c * n:(c + 1) * n]
                    for c in range(rows.shape[0] // n)]
        return [h.result() for h in self._handles]


def configure_classes_async(params: DvfsParams, allowed: np.ndarray,
                            classes: Sequence[MachineClass],
                            interval: ScalingInterval = dvfs.WIDE,
                            use_kernel: bool = False,
                            dedup: bool = True, device=None) -> ClassSolves:
    """Dispatch Algorithm 1 for a *chunk* of tasks on every class without
    blocking — the prefetch half of the pipelined online scheduler.

    Mirrors :func:`configure_classes` batch shape for batch shape: the
    kernel path stacks the class blocks (with per-row interval bounds)
    into ONE launch, the grid+golden path issues one per-class solve.  Rows are
    keyed and cached exactly like the synchronous path (same tags), so the
    values that come back are bit-identical and the cache composes across
    pipelined and monolithic runs.
    """
    from repro_torch.core import solver_cache
    from repro_torch.kernels import ops as kernel_ops

    device = kernel_ops.resolve_device(device)
    allowed = np.asarray(allowed, dtype=np.float64)
    if not use_kernel:
        return ClassSolves(handles=[
            single_task.solve_rows_async(
                mc.adapt(params), allowed, mc.effective_interval(interval),
                boundary=False, use_kernel=False, dedup=dedup, device=device)
            for mc in classes])

    n = allowed.shape[0]
    adapted = [mc.adapt(params) for mc in classes]
    ivs = [mc.effective_interval(interval) for mc in classes]
    big = DvfsParams(*(np.concatenate([np.asarray(f, np.float64)
                                       for f in cols])
                       for cols in zip(*(a.astuple() for a in adapted))))
    interval_rows = np.concatenate(
        [np.broadcast_to(np.asarray(iv.bounds(), np.float64),
                         (n, layout.N_BOUNDS))
         for iv in ivs], axis=0)
    keys = solver_cache.build_keys(big.astuple(), np.tile(allowed, len(ivs)),
                                   False, interval_rows)
    handle = solver_cache.solve_rows_async(
        keys, lambda km: kernel_ops.dvfs_solve_matrix(km, device=device,
                                                      block=False),
        tag=kernel_ops.kernel_tag(device),
        cache=solver_cache.GLOBAL_CACHE if dedup else None, unique=False)
    return ClassSolves(stacked=handle, n=n)


def default_configs(task_set, classes: Sequence[MachineClass],
                    allowed=None) -> List[TaskConfig]:
    """The no-DVFS configuration per class: every task at (1, 1, 1) with the
    class-adapted constants — one :func:`repro_torch.core.single_task.no_dvfs_config`
    per class (the same implementation ``scheduling.default_config`` wraps,
    so the homogeneous and heterogeneous fallbacks cannot drift).
    ``allowed`` overrides the per-task window (the online scheduler passes
    the slot-aligned ``d - ceil(a)``); default is the offline ``d - a``."""
    if allowed is None:
        allowed = np.asarray(task_set.deadline - task_set.arrival, np.float64)
    return [single_task.no_dvfs_config(mc.adapt(task_set.params), allowed)
            for mc in classes]


def class_order(cfgs: Sequence[TaskConfig]) -> np.ndarray:
    """Per-task class preference, shape ``[C, n]``: feasible classes in
    ascending optimized energy first, then infeasible ones by energy.
    ``class_order(cfgs)[0]`` is each task's *primary* class."""
    e = np.stack([np.asarray(c.e_hat, np.float64) for c in cfgs])
    feas = np.stack([np.asarray(c.feasible, bool) for c in cfgs])
    key = np.where(feas, e, e + INFEASIBLE_PENALTY)
    return np.argsort(key, axis=0, kind="stable")


def readjust_classes(params: DvfsParams, rows: np.ndarray, windows: np.ndarray,
                     class_ids: np.ndarray, classes: Sequence[MachineClass],
                     interval: ScalingInterval, use_kernel: bool,
                     dedup: bool = True, device=None):
    """Batched θ-readjustment across classes: one deadline-boundary dispatch
    per class present in ``class_ids`` (≤ C dispatches per run) on
    ``device``.

    Returns ``(v, fc, fm, t, p, e)`` arrays aligned with ``rows``.
    """
    n = rows.shape[0]
    v, fc, fm, t, p, e = (np.zeros(n) for _ in range(6))
    for cid in np.unique(class_ids):
        mc = classes[int(cid)]
        m = class_ids == cid
        sub = mc.adapt(params[rows[m]])
        out = single_task.readjust_batch(sub, windows[m],
                                         mc.effective_interval(interval),
                                         use_kernel=use_kernel, dedup=dedup,
                                         device=device)
        for dst, src in zip((v, fc, fm, t, p, e), out):
            dst[m] = src
    return v, fc, fm, t, p, e
