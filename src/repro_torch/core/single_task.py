"""Single-task DVFS optimization (paper S4.1, Algorithm 1).

Two sub-problems, both reduced to a 1-D minimization:

* **Unconstrained** ``argmin E(V, fc, fm)``: the paper's Theorem 1 shows
  ``dE/dV > 0`` everywhere, so the optimum has the *minimum voltage that
  sustains the chosen core frequency*, ``V = max(v_min, g1^{-1}(fc))``; and for
  fixed ``(V, fc)`` the optimal memory frequency has the closed form
  :func:`repro_torch.core.dvfs.optimal_fm`.  That leaves a single decision
  variable ``fc in [fc_min, g1(v_max)]`` which we minimize with a coarse grid
  followed by golden-section refinement.

* **Deadline-constrained** (deadline-prior tasks, ``t_hat > d - a``): the
  optimum sits on the time boundary ``t(fc, fm) = allowed``.  Parametrizing by
  ``fm``, the required core frequency is
  ``fc_req(fm) = D delta / (allowed - t0 - D (1 - delta) / fm)`` and
  ``V = max(v_min, g1^{-1}(fc))``; again a 1-D search over ``fm``.

The solvers are batched torch code on the caller's device (``device=None``
means the CUDA card; ``device="cpu"`` runs them on the host).  They are the
``use_kernel=False`` path; ``use_kernel=True`` sends the same rows through
the hand-written CUDA kernel of :mod:`repro_torch.kernels.dvfs_opt`.  The
JAX package's ``jax.vmap`` over the 65 grid points is a ``[65, n]`` batch
dimension here, and its ``lax.scan`` of golden steps a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dvfs, solver_cache
from repro_torch.core.dvfs import DvfsParams, ScalingInterval
from repro_torch.core.solver_cache import to_numpy
from repro_torch.kernels import layout
from repro_torch.kernels.layout import DvfsSolution  # noqa: F401  (re-export)

INV_PHI = 0.6180339887498949  # 1/golden ratio
GRID_POINTS = 65
GOLDEN_ITERS = 40


def _resolve(device) -> torch.device:
    from repro_torch.kernels.ops import resolve_device

    return resolve_device(device)


def _on(params: DvfsParams, device: torch.device) -> DvfsParams:
    """The six fields as float32 tensors on ``device`` (the reference's
    ``jnp.asarray(f, jnp.float32)``: float64 rounds to nearest)."""
    return DvfsParams(*(_f32_on(f, device) for f in params.astuple()))


def _f32_on(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, np.float32, ndmin=1)).to(device)


def solver_tag(kind: str, device: torch.device) -> str:
    """Solve-cache tag of a grid+golden solver (``kind`` "dl", "bd" or
    "unc") on ``device``: the CPU and CUDA runs never serve each other's
    rows."""
    return f"torch-{kind}@{device.type}"


# ---------------------------------------------------------------------------
# Unconstrained optimum.
# ---------------------------------------------------------------------------


def _energy_of_fc(params: DvfsParams, fc, interval: ScalingInterval):
    """Energy along the optimal-V / optimal-fm manifold, as a function of fc."""
    v = torch.clamp(dvfs.g1_inv(fc), min=interval.v_min)
    fm = dvfs.optimal_fm(params, v, fc, interval)
    return dvfs.energy(params, v, fc, fm), (v, fm)


def _golden_minimize(fn, lo, hi, iters: int = GOLDEN_ITERS):
    """Vectorized golden-section minimization of ``fn`` over ``[lo, hi]``."""
    for _ in range(iters):
        d = (hi - lo) * INV_PHI
        x1 = hi - d
        x2 = lo + d
        shrink_right = fn(x1) < fn(x2)  # minimum is in [lo, x2]
        lo, hi = torch.where(shrink_right, lo, x1), torch.where(shrink_right, x2, hi)
    return 0.5 * (lo + hi)


def _grid_then_golden(fn, lo, hi, n_grid: int = GRID_POINTS):
    """Coarse grid scan to bracket the global minimum, then golden refine.

    ``lo``/``hi`` are per-task ``[n]`` tensors. Returns the argmin x.
    """
    # == jnp.linspace(0, 1, n_grid) in float32, bit for bit (the divisor is
    # a tensor: a CUDA tensor over a Python scalar multiplies by the
    # reciprocal instead of dividing).
    ts = (torch.arange(n_grid, dtype=torch.float32, device=lo.device)
          / torch.tensor(float(n_grid - 1), device=lo.device))
    vals = fn(lo[None, :] + (hi - lo)[None, :] * ts[:, None])  # [n_grid, n]
    best = torch.argmin(vals, dim=0)   # first index on ties, as jnp.argmin
    step = 1.0 / (n_grid - 1)
    frac_lo = torch.clamp(best * step - step, 0.0, 1.0)
    frac_hi = torch.clamp(best * step + step, 0.0, 1.0)
    x = _golden_minimize(lambda f: fn(lo + (hi - lo) * f), frac_lo, frac_hi)
    return lo + (hi - lo) * x


def _unconstrained(params: DvfsParams, interval: ScalingInterval) -> DvfsSolution:
    """:func:`solve_unconstrained` on params already on their device."""

    def efc(fc):
        return _energy_of_fc(params, fc, interval)[0]

    lo = torch.full_like(params.big_d, interval.fc_min)
    hi = torch.full_like(params.big_d, interval.fc_max)
    fc = _grid_then_golden(efc, lo, hi)
    e, (v, fm) = _energy_of_fc(params, fc, interval)
    t = dvfs.exec_time(params, fc, fm)
    p = dvfs.power(params, v, fc, fm)
    true_ = torch.ones_like(e, dtype=torch.bool)
    return DvfsSolution(v, fc, fm, t, p, e, ~true_, true_)


def solve_unconstrained(params: DvfsParams, interval: ScalingInterval = dvfs.WIDE,
                        device=None) -> DvfsSolution:
    """argmin_{V, fc, fm} E for each task, ignoring deadlines (paper Eq. 9).
    Returns float32 / bool tensors on ``device``."""
    return _unconstrained(_on(params, _resolve(device)), interval)


# ---------------------------------------------------------------------------
# Deadline-constrained optimum.
# ---------------------------------------------------------------------------


def _deadline_energy_of_fm(params: DvfsParams, fm, allowed, interval: ScalingInterval):
    """Energy on the ``t = allowed`` boundary parametrized by fm.

    Infeasible fm (required fc above fc_max, or non-positive time budget for
    the core component) get +inf energy.
    """
    slack = allowed - params.t0 - params.big_d * (1.0 - params.delta) / fm
    fc_req = params.big_d * params.delta / torch.clamp(slack, min=1e-30)
    # delta == 0: any fc meets the deadline; run the core floor.
    fc_req = torch.where(params.delta <= 0.0, interval.fc_min, fc_req)
    infeasible = (slack <= 0.0) & (params.delta > 0.0)
    fc = torch.clamp(fc_req, interval.fc_min, interval.fc_max)
    v = torch.clamp(dvfs.g1_inv(fc), min=interval.v_min)
    t = dvfs.exec_time(params, fc, fm)
    e = dvfs.power(params, v, fc, fm) * t
    e = torch.where(infeasible | (fc_req > interval.fc_max + 1e-6), torch.inf, e)
    return e, (v, fc)


def _boundary_optimum(params: DvfsParams, allowed, interval: ScalingInterval):
    """The deadline-boundary optimum ``(v, fc, fm)``: 1-D search over fm on
    the ``t(fc, fm) = allowed`` manifold (params/allowed already f32)."""

    def efm(fm):
        return _deadline_energy_of_fm(params, fm, allowed, interval)[0]

    lo = torch.full_like(params.big_d, interval.fm_min)
    hi = torch.full_like(params.big_d, interval.fm_max)
    fm = _grid_then_golden(efm, lo, hi)
    _, (v, fc) = _deadline_energy_of_fm(params, fm, allowed, interval)
    return v, fc, fm


def _with_deadline(params: DvfsParams, allowed: torch.Tensor,
                   interval: ScalingInterval) -> DvfsSolution:
    """:func:`solve_with_deadline` on inputs already on their device."""
    unc = _unconstrained(params, interval)
    energy_prior = unc.time <= allowed + 1e-6

    v, fc, fm = _boundary_optimum(params, allowed, interval)

    # Infeasible deadline => max speed, still report honestly.
    tmin = dvfs.min_time(params, interval)
    feasible = allowed >= tmin - 1e-6
    vmax = torch.full_like(v, interval.v_max)
    fcmax = torch.full_like(fc, interval.fc_max)
    fmmax = torch.full_like(fm, interval.fm_max)

    def pick(con_val, unc_val, max_val):
        x = torch.where(energy_prior, unc_val, con_val)
        return torch.where(feasible, x, max_val)

    v = pick(v, unc.v, vmax)
    fc = pick(fc, unc.fc, fcmax)
    fm = pick(fm, unc.fm, fmmax)
    t = dvfs.exec_time(params, fc, fm)
    p = dvfs.power(params, v, fc, fm)
    e = p * t
    return DvfsSolution(v, fc, fm, t, p, e, ~energy_prior, feasible)


def solve_with_deadline(params: DvfsParams, allowed,
                        interval: ScalingInterval = dvfs.WIDE,
                        device=None) -> DvfsSolution:
    """Optimal setting subject to ``t <= allowed`` (Algorithm 1 body).

    Tasks whose unconstrained optimum already fits (``t_hat <= allowed``) keep
    it (energy-prior); the rest are re-solved on the deadline boundary
    (deadline-prior).  Tasks that cannot meet the deadline even at maximum
    frequencies are flagged infeasible and returned at max speed.
    """
    device = _resolve(device)
    return _with_deadline(_on(params, device), _f32_on(allowed, device),
                          interval)


def _on_boundary(params: DvfsParams, allowed: torch.Tensor,
                 interval: ScalingInterval) -> DvfsSolution:
    """:func:`solve_on_boundary` on inputs already on their device."""
    v, fc, fm = _boundary_optimum(params, allowed, interval)

    tmin = dvfs.min_time(params, interval)
    feasible = allowed >= tmin - 1e-6
    v = torch.where(feasible, v, interval.v_max)
    fc = torch.where(feasible, fc, interval.fc_max)
    fm = torch.where(feasible, fm, interval.fm_max)
    t = dvfs.exec_time(params, fc, fm)
    p = dvfs.power(params, v, fc, fm)
    dp = torch.ones_like(feasible)
    return DvfsSolution(v, fc, fm, t, p, p * t, dp, feasible)


def solve_on_boundary(params: DvfsParams, allowed,
                      interval: ScalingInterval = dvfs.WIDE,
                      device=None) -> DvfsSolution:
    """The deadline-boundary solve used by theta-readjustment.

    A readjustment shrinks a task's window *below* its optimal execution
    time, so the constrained optimum sits on the ``t = allowed`` boundary by
    construction — no unconstrained solve or energy-prior comparison is
    needed.  Windows below ``t_min`` fall back to max speed (infeasible).
    """
    device = _resolve(device)
    return _on_boundary(_on(params, device), _f32_on(allowed, device), interval)


# ---------------------------------------------------------------------------
# Algorithm 1: voltage/frequency configuration for a task set.
# ---------------------------------------------------------------------------


class TaskConfig(NamedTuple):
    """Numpy view of Algorithm 1's output, consumed by the schedulers."""

    v: np.ndarray
    fc: np.ndarray
    fm: np.ndarray
    t_hat: np.ndarray          # optimized execution time (paper's t-hat / t-hat')
    p_hat: np.ndarray
    e_hat: np.ndarray
    t_min: np.ndarray          # fastest achievable time (theta floor)
    deadline_prior: np.ndarray
    feasible: np.ndarray
    n_deadline_prior: int


def pad_pow2(params: DvfsParams, allowed, extra_rows: np.ndarray = None):
    """Pad a batch to the next power of two (>= 8) by replicating the last
    task, so the solvers see O(log n) distinct shapes over a day-long online
    simulation instead of one per slot population.

    ``extra_rows`` (``[n, k]``, e.g. per-row interval bounds) is padded the
    same way; returns ``(params, allowed, extra_rows, n)``.
    """
    n = int(np.shape(np.asarray(params.p0))[0])
    n_pad = max(8, 1 << (n - 1).bit_length())
    if n_pad != n:
        pad = n_pad - n
        params = DvfsParams(*(np.concatenate(
            [np.asarray(f, np.float64), np.full(pad, np.asarray(f)[-1])])
            for f in params.astuple()))
        allowed = np.concatenate(
            [np.asarray(allowed, np.float64),
             np.full(pad, np.asarray(allowed)[-1])])
        if extra_rows is not None:
            extra_rows = np.concatenate(
                [extra_rows,
                 np.broadcast_to(extra_rows[-1], (pad, extra_rows.shape[1]))],
                axis=0)
    return params, allowed, extra_rows, n


def config_from_solution(sol: DvfsSolution, params: DvfsParams, allowed,
                         interval: ScalingInterval,
                         tmin: np.ndarray = None) -> TaskConfig:
    """TaskConfig assembly shared by :func:`configure_tasks` and the
    heterogeneous class path (``machines.configure_classes``): the t_min
    floor plus snapping the deadline-boundary f32 residual to ``allowed``
    so downstream deadline checks are exact.  ``sol`` may hold tensors on
    any device; they are copied to the host here.

    ``tmin`` short-circuits the :func:`repro_torch.core.dvfs.min_time` call
    when the caller already holds it — the pipelined online path computes
    the whole horizon's floors once up front and passes per-chunk slices
    (``min_time`` is elementwise, so slices are bitwise equal)."""
    sol = DvfsSolution(*(to_numpy(f) for f in sol))
    if tmin is None:
        tmin = np.asarray(dvfs.min_time(params, interval))
    allowed_arr = np.broadcast_to(np.asarray(allowed, np.float64),
                                  sol.time.shape)
    t_hat = np.where(sol.deadline_prior & sol.feasible,
                     np.minimum(sol.time, allowed_arr), sol.time)
    return TaskConfig(
        v=sol.v, fc=sol.fc, fm=sol.fm,
        t_hat=t_hat, p_hat=sol.power, e_hat=sol.power * t_hat,
        t_min=np.broadcast_to(tmin, sol.time.shape).copy(),
        deadline_prior=sol.deadline_prior, feasible=sol.feasible,
        n_deadline_prior=int(np.sum(sol.deadline_prior)),
    )


def no_dvfs_config(params: DvfsParams, allowed) -> TaskConfig:
    """The no-DVFS configuration: every task runs at ``(1, 1, 1)``.

    The ONE implementation behind both ``scheduling.default_config``
    (homogeneous) and ``machines.default_configs`` (per adapted class), so
    the ``(1, 1, 1)`` fallback cannot drift between the two paths.  With no
    scaling there is no shrink room: ``t_min == t_hat == t*``.
    """
    allowed = np.asarray(allowed, dtype=np.float64)
    t_star = np.asarray(params.default_time())
    p_star = np.asarray(params.default_power())
    ones = np.ones(t_star.shape[0])
    deadline_prior = t_star > allowed + 1e-9
    return TaskConfig(
        v=ones.copy(), fc=ones.copy(), fm=ones.copy(),
        t_hat=t_star.copy(), p_hat=p_star.copy(), e_hat=(p_star * t_star),
        t_min=t_star.copy(),
        deadline_prior=deadline_prior,
        feasible=~deadline_prior,
        n_deadline_prior=int(np.sum(deadline_prior)),
    )


def max_speed_setting(params: DvfsParams,
                      interval: ScalingInterval = dvfs.WIDE):
    """Every task at the interval's maximum speed: ``(v_max, fc_max,
    fm_max)``, with ``t`` equal to the class ``t_min`` bitwise (both are
    :func:`repro_torch.core.dvfs.min_time` on the same params/interval).

    The graceful-degradation setting of the fault-recovery policy
    (:meth:`repro_torch.core.placement.PlacementContext.place_orphans`): a
    task re-placed after a server failure that cannot meet its deadline on
    any pair runs flat out, and the remaining miss is counted as a
    violation.  Host math only; returns numpy arrays ``(v, fc, fm, t, p)``.
    """
    t = np.asarray(dvfs.min_time(params, interval), np.float64)
    p = np.asarray(dvfs.power(params, interval.v_max, interval.fc_max,
                              interval.fm_max), np.float64)
    n = t.shape[0]
    return (np.full(n, interval.v_max), np.full(n, interval.fc_max),
            np.full(n, interval.fm_max), t, np.broadcast_to(p, (n,)))


_SOLVERS = {
    "dl": _with_deadline,
    "bd": _on_boundary,
    "unc": lambda params, allowed, interval: _unconstrained(params, interval),
}


def row_solver(kind: str, interval: ScalingInterval, device: torch.device):
    """``[m, 13]`` f32 key matrix -> ``[m, 8]`` f32 solution rows on
    ``device``, through the grid+golden solver ``kind`` ("dl" deadline,
    "bd" boundary, "unc" unconstrained).  Not synchronised: on CUDA the rows
    are still being computed when this returns."""
    solver = _SOLVERS[kind]

    def solve(km: np.ndarray) -> torch.Tensor:
        k = torch.from_numpy(np.ascontiguousarray(km)).to(device)
        p = DvfsParams(*(k[:, i] for i in range(layout.N_PARAMS)))
        sol = solver(p, k[:, layout.ALLOWED], interval)
        return torch.stack([f.to(torch.float32) for f in sol], dim=1)

    return solve


def _dedup_solve(params: DvfsParams, allowed, interval: ScalingInterval,
                 boundary: bool, device: torch.device) -> DvfsSolution:
    """Route a batched grid+golden solve through the unique-row dedup +
    process-wide LRU cache (:mod:`repro_torch.core.solver_cache`).

    Bit-identical to the direct solve: the f32 key matrix IS the solver
    input (both solvers cast to f32 before computing) and every solver is
    row-independent, so deduped rows scatter back to exactly the values a
    full-batch solve would produce.
    """
    kind = "bd" if boundary else "dl"
    keys = solver_cache.build_keys(
        params.astuple(), allowed, boundary,
        np.asarray(interval.bounds(), np.float32))
    rows = solver_cache.solve_rows(keys, row_solver(kind, interval, device),
                                   tag=solver_tag(kind, device))
    return solver_cache.rows_to_solution(rows)


def solve_rows_async(params: DvfsParams, allowed,
                     interval: ScalingInterval, *, boundary: bool,
                     use_kernel: bool = False, dedup: bool = True,
                     device=None):
    """Dispatch one solve batch without blocking — the pipelined online
    scheduler's per-chunk entry point.

    Builds the f32 key matrix, probes the cache, and dispatches only the
    misses; returns a :class:`repro_torch.core.solver_cache.AsyncSolve`
    whose ``.result()`` is bit-identical to the synchronous
    :func:`configure_tasks` / :func:`readjust_batch` solves (same tags, so
    the cache composes across both paths).  Both paths leave the solution
    rows on the device (CUDA launches are asynchronous); ``.result()``
    copies them to the host.

    Chunks skip the sort-based intra-batch unique pass
    (``solve_rows_async(unique=False)``): online chunks are nearly
    duplicate-free, so the cache probe alone carries the dedup and
    cross-chunk repeats still hit.
    """
    device = _resolve(device)
    keys = solver_cache.build_keys(
        params.astuple(), allowed, boundary,
        np.asarray(interval.bounds(), np.float32))
    cache = solver_cache.GLOBAL_CACHE if dedup else None
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        tag = kernel_ops.kernel_tag(device)

        def solve(km: np.ndarray):
            return kernel_ops.dvfs_solve_matrix(km, device=device, block=False)

    else:
        kind = "bd" if boundary else "dl"
        tag = solver_tag(kind, device)
        solve = row_solver(kind, interval, device)

    return solver_cache.solve_rows_async(keys, solve, tag=tag, cache=cache,
                                         unique=False)


def configure_tasks(params: DvfsParams, allowed, interval: ScalingInterval = dvfs.WIDE,
                    use_kernel: bool = False, dedup: bool = True,
                    device=None) -> TaskConfig:
    """Algorithm 1: per-task optimal DVFS settings for a whole task set.

    ``allowed`` is ``d - a`` per task.  With ``use_kernel=True`` the batched
    CUDA kernel (its plain torch version on ``device="cpu"``) computes the
    whole solve.  ``dedup=True`` (default) solves only unique
    ``(params, allowed)`` rows and serves repeats — within this call or from
    any previous one — out of the process-wide solve cache, bit-identically.
    """
    device = _resolve(device)
    params, allowed, _, n = pad_pow2(params, allowed)
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        sol = kernel_ops.dvfs_solve(params, np.asarray(allowed), interval,
                                    dedup=dedup, device=device)
    elif dedup:
        sol = _dedup_solve(params, allowed, interval, boundary=False,
                           device=device)
    else:
        sol = solve_with_deadline(params, allowed, interval, device=device)
    if np.shape(np.asarray(params.p0))[0] != n:
        sol = DvfsSolution(*(to_numpy(f)[:n] for f in sol))
        params = params[:n]
        allowed = np.asarray(allowed)[:n]
    return config_from_solution(sol, params, allowed, interval)


def readjust_batch(params: DvfsParams, windows, interval: ScalingInterval = dvfs.WIDE,
                   use_kernel: bool = False, dedup: bool = True, device=None):
    """Batched theta-readjustment: re-solve ``n`` tasks with shrunken time
    budgets in ONE solver dispatch (Algorithm 2 lines 16-19 / Algorithm 5).

    A readjusted window sits below the task's optimal execution time by
    construction, so every row takes the deadline-boundary branch; with
    ``use_kernel=True`` the whole batch goes through the kernel's readjust
    sweep in a single launch.  Returns numpy arrays ``(v, fc, fm, t, p, e)``
    with ``t`` snapped to the window where feasible (so scheduler mu updates
    land exactly on the deadline).
    """
    device = _resolve(device)
    windows = np.asarray(windows, dtype=np.float64)
    params, padded, _, n = pad_pow2(params, windows)
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        sol = kernel_ops.dvfs_solve(params, np.asarray(padded), interval,
                                    readjust=True, dedup=dedup, device=device)
    elif dedup:
        sol = _dedup_solve(params, padded, interval, boundary=True,
                           device=device)
    else:
        sol = solve_on_boundary(params, padded, interval, device=device)
    v, fc, fm, t, p = (to_numpy(f).astype(np.float64)[:n]
                       for f in (sol.v, sol.fc, sol.fm, sol.time, sol.power))
    feas = to_numpy(sol.feasible)[:n]
    t = np.where(feas, np.minimum(t, windows), t)  # snap the f32 residual
    return v, fc, fm, t, p, p * t


def readjust(params: DvfsParams, new_allowed: float,
             interval: ScalingInterval = dvfs.WIDE, device=None):
    """theta-readjustment: re-solve one task with a shrunken time budget.

    Returns ``(v, fc, fm, t, p, e)`` as python floats.  Thin scalar wrapper
    over :func:`readjust_batch`: ``new_allowed`` must sit below the task's
    unconstrained optimal time (the readjustment regime) — the boundary
    solution is returned unconditionally, so a window wide enough for the
    interior optimum would come back pessimally stretched to fill it.
    """
    batched = DvfsParams(*(np.asarray([f], dtype=np.float64) for f in params.astuple()))
    out = readjust_batch(batched, np.asarray([float(new_allowed)]), interval,
                         device=device)
    return tuple(float(np.asarray(f)[0]) for f in out)
