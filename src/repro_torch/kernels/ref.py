"""The oracle for the ``dvfs_opt`` kernel: the production grid+golden
solver (the allclose target of the kernel tests)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import single_task
from repro_torch.core.dvfs import WIDE, DvfsParams, ScalingInterval
from repro_torch.core.solver_cache import to_numpy
from repro_torch.kernels import layout as L


def dvfs_solve_ref(tasks: np.ndarray, interval: ScalingInterval = WIDE,
                   device=None) -> np.ndarray:
    """Oracle for dvfs_opt: the production grid+golden solver on ``device``.

    Column 7 > 0.5 flags a theta-readjustment row: those take the forced
    deadline-boundary solve (``solve_on_boundary``), matching the kernel's
    readjust sweep.

    A widened ``[n, 16]`` matrix (``layout.BOUNDS_SLICE`` = per-row
    interval bounds, the heterogeneous-class layout) is solved by grouping
    rows that share a scaling box and running the production solver once
    per group — exactly the semantics of the kernel's per-row bounds."""
    if tasks.shape[1] >= L.KEY_COLS:
        bounds = np.asarray(tasks[:, L.BOUNDS_SLICE], np.float32)
        out = np.zeros((tasks.shape[0], L.SOL_COLS), np.float32)
        for row in np.unique(bounds, axis=0):
            m = np.all(bounds == row, axis=1)
            iv = ScalingInterval(*(float(x) for x in row))
            out[m] = dvfs_solve_ref(tasks[m, :L.LEGACY_NCOL], iv, device)
        return out
    params = DvfsParams(p0=tasks[:, L.P0], gamma=tasks[:, L.GAMMA],
                        c=tasks[:, L.C_COEF], big_d=tasks[:, L.BIG_D],
                        delta=tasks[:, L.DELTA], t0=tasks[:, L.T0])
    allowed = tasks[:, L.ALLOWED]
    sol = single_task.solve_with_deadline(params, allowed, interval,
                                          device=device)
    readj = tasks[:, L.READJUST] > 0.5
    if np.any(readj):
        bnd = single_task.solve_on_boundary(params, allowed, interval,
                                            device=device)
        keep = torch.from_numpy(readj).to(sol.v.device)
        sol = type(sol)(*(torch.where(keep, b, s) for s, b in zip(sol, bnd)))
    sol = type(sol)(*(to_numpy(f) for f in sol))
    t = sol.time
    dp = sol.deadline_prior
    feas = sol.feasible
    t = np.where(dp & feas, np.minimum(t, allowed), t)
    p = sol.power
    return np.stack([sol.v, sol.fc, sol.fm, t, p, p * t,
                     dp.astype(np.float32), feas.astype(np.float32)], axis=1)
