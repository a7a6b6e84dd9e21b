"""Analytical energy bounds (paper §5): the savings ceiling every
scheduling result is measured against.

The paper's headline claim is *comparable energy savings to the
theoretical upper bound*: with the wide (analytic) GPU scaling interval at
most ~36% of energy can be saved, and the schedulers record 33-35%.  The
bound is the energy no schedule can beat:

* **run floor** — every task at its *unconstrained* optimum (Algorithm 1
  with the deadline dropped) on its cheapest machine class.  Any feasible
  setting of any class costs at least this much, deadline-constrained or
  θ-readjusted settings strictly more.
* **exact-fit idle floor** — a packing in which every pair of every
  (virtual) server stays busy until the server's span ends leaves zero
  idle energy, so the offline (Eq. 6) floor is 0.  Online (Eq. 7) the DRS
  rule itself puts a floor under the books: at least one server must power
  on (``Δ`` per pair of turn-on overhead) and each of its ``l`` pairs
  idles exactly ``ρ`` slots between its last finish and the power-off
  event, whatever the schedule does.

``savings_ceiling`` relates the bound to the paper's no-DVFS ``l = 1``
baseline (:func:`repro_torch.core.cluster.baseline_energy`); on the synthesized
20-app library it reproduces the §5 wide-interval ~36% anchor
(``tests/test_placement.py`` pins it).  Both schedulers report
``ScheduleResult.e_bound`` from here so every benchmark row shows
achieved-vs-bound.

See docs/EQUATIONS.md for the equation/algorithm -> code map.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cluster as cl, dvfs, machines, single_task, solver_cache
from repro_torch.core.dvfs import ScalingInterval
from repro_torch.kernels import layout


@dataclasses.dataclass(frozen=True)
class EnergyBound:
    """The §5 lower bound on schedule energy (= upper bound on savings)."""

    e_run: float        # sum of per-task unconstrained optima, cheapest class
    e_idle: float       # exact-fit idle floor (0 offline; P_idle*rho*l online)
    e_overhead: float   # DRS turn-on floor (0 offline; Delta*l online)
    e_baseline: float   # no-DVFS l=1 reference, sum_i P*_i t*_i

    @property
    def e_bound(self) -> float:
        """The energy no schedule of this task set can beat."""
        return self.e_run + self.e_idle + self.e_overhead

    @property
    def savings_ceiling(self) -> float:
        """Max achievable saving vs the no-DVFS baseline (paper: ~0.36 on
        the wide interval, where the schedulers record 0.33-0.35)."""
        if self.e_baseline <= 0.0:
            return 0.0
        return 1.0 - self.e_bound / self.e_baseline


def unconstrained_energies(params, classes, interval: ScalingInterval,
                           n: int, dedup: bool = True,
                           device=None) -> np.ndarray:
    """Per-task unconstrained-optimum energy on each class, shape ``[C, n]``
    (``params`` may be pow-2 padded past ``n``; one batched grid+golden
    solve per class on ``device``).

    ``dedup=True`` (default) keys each row as ``(params, allowed=+inf)`` in
    the process-wide solve cache, so re-evaluating the bound across sweep
    cells (every scenario knob calls :func:`theoretical_bound` on the same
    task set) never re-solves a row.
    """
    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)
    out = np.empty((len(classes), n))
    for k, mc in enumerate(classes):
        adapted = mc.adapt(params)
        iv = mc.effective_interval(interval)
        if dedup:
            n_rows = np.shape(np.asarray(adapted.p0))[0]
            keys = solver_cache.build_keys(
                adapted.astuple(), np.full(n_rows, np.inf, np.float32),
                False, np.asarray(iv.bounds(), np.float32))
            rows = solver_cache.solve_rows(
                keys, single_task.row_solver("unc", iv, device),
                tag=single_task.solver_tag("unc", device))
            out[k] = np.asarray(rows[:, layout.SOL_E], np.float64)[:n]
        else:
            sol = single_task.solve_unconstrained(adapted, iv, device=device)
            out[k] = solver_cache.to_numpy(sol.energy).astype(np.float64)[:n]
    return out


def theoretical_bound(task_set, interval: ScalingInterval = dvfs.WIDE,
                      classes=None, p_idle: float = cl.P_IDLE,
                      delta_on: float = cl.DELTA_ON, l: int = 1,
                      rho: int = 0, dedup: bool = True,
                      device=None) -> EnergyBound:
    """The paper's §5 analytical bound for a task set.

    ``classes`` is any class-mix spec (``None`` = the homogeneous reference
    setup with the scalar ``p_idle``/``delta_on``).  ``rho > 0`` adds the
    online DRS floors (at least one power-on of ``l`` pairs, each idling
    exactly ``rho`` before the off event); the offline bound leaves them at
    the exact-fit 0.  The floors use the cheapest class's constants so the
    bound stays valid for any class mix.  The solves run on ``device``
    (``None`` = the CUDA card).
    """
    from repro_torch.kernels.ops import resolve_device

    device = resolve_device(device)
    mcs = machines.resolve_classes(classes, p_idle=p_idle, delta_on=delta_on)
    n = len(task_set)
    e_baseline = cl.baseline_energy(task_set)
    if n == 0:
        return EnergyBound(0.0, 0.0, 0.0, e_baseline)
    params, _, _, _ = single_task.pad_pow2(task_set.params, np.zeros(n))
    e_run = float(np.min(
        unconstrained_energies(params, mcs, interval, n, dedup=dedup,
                               device=device),
        axis=0).sum())
    if rho > 0:
        e_idle = min(mc.p_idle for mc in mcs) * rho * l
        e_overhead = min(mc.delta_on for mc in mcs) * l
    else:
        e_idle = e_overhead = 0.0
    return EnergyBound(e_run, e_idle, e_overhead, e_baseline)
