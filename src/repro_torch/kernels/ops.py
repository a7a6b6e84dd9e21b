"""Public wrappers around the port's kernels, and its one device policy.

Every entry point of the port that solves takes ``device=None`` and passes
it through :func:`resolve_device`: ``None`` means the CUDA card, and
without one it raises rather than running quietly on the host.  The tests
pass ``device="cpu"``, which sends every solve through the plain torch
versions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import solver_cache
from repro_torch.core.dvfs import WIDE, DvfsParams, ScalingInterval
from repro_torch.kernels import layout
from repro_torch.kernels.dvfs_opt import DEFAULT_GRID, dvfs_solve_kernel
from repro_torch.kernels.layout import DvfsSolution


def resolve_device(device=None) -> torch.device:
    """THE ``device=`` policy of every solving entry point: ``None`` is the
    CUDA card; a CUDA device without CUDA, or ``None`` without it, raises.
    Pass ``device="cpu"`` to run the plain versions on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run the plain torch versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           "available")
    return dev


def kernel_tag(device: torch.device, grid: tuple = DEFAULT_GRID) -> str:
    """Solve-cache tag of the kernel path: the sweep grid and the device
    type, so the CUDA kernel and its plain version on the CPU never serve
    each other's rows."""
    return f"k{int(grid[0])}x{int(grid[1])}@{device.type}"


def dvfs_solve_matrix(mat: np.ndarray, *, grid: tuple = DEFAULT_GRID,
                      device=None, block: bool = True):
    """Solve a ``[m, 16]`` (or ``[m, 13]`` key-layout) task matrix with the
    kernel on ``device``.  Returns the ``[m, 8]`` solution matrix as numpy.

    ``block=False`` is the pipelined scheduler's entry point: the kernel is
    launched but the host does NOT wait for it — the return value is the
    solution tensor on the device, still being computed, which
    ``solver_cache._materialize`` copies to the host at the pipeline's sync
    point.  The whole matrix goes to one card.
    """
    device = resolve_device(device)
    mat = np.asarray(mat, np.float32)
    if mat.shape[1] == layout.KEY_COLS:  # widen key layout -> NCOL
        mat = np.concatenate(
            [mat, np.zeros((mat.shape[0], layout.NCOL - layout.KEY_COLS),
                           np.float32)], axis=1)
    tasks = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    out = dvfs_solve_kernel(tasks, grid=grid)
    return solver_cache.to_numpy(out) if block else out


def dvfs_solve(params: DvfsParams, allowed: np.ndarray,
               interval: ScalingInterval = WIDE,
               readjust: bool = False,
               interval_rows: Optional[np.ndarray] = None,
               dedup: bool = True,
               grid: tuple = DEFAULT_GRID,
               cache: Optional["solver_cache.SolveCache"] = None,
               device=None) -> DvfsSolution:
    """Batched single-task DVFS optimum via the kernel.

    Drop-in for ``single_task.solve_with_deadline`` (same DvfsSolution
    contract, numpy fields; used by ``configure_tasks(use_kernel=True)``).
    With ``readjust=True`` every row is flagged as a theta-readjustment
    (column 7 of the task matrix): the kernel then takes the
    deadline-boundary sweep unconditionally — the drop-in for
    ``single_task.solve_on_boundary`` used by
    ``readjust_batch(use_kernel=True)``.

    ``interval_rows`` (``[n, 5]``: v_min, v_max, fc_min, fm_min, fm_max)
    gives every row its own scaling box — the heterogeneous-class path
    (``machines.configure_classes``) stacks one class block per interval
    and solves them all in this one launch.  When omitted, the static
    ``interval`` applies to every row.

    ``dedup=True`` routes the matrix through the unique-row dedup +
    process-wide LRU solve cache (:mod:`repro_torch.core.solver_cache`) —
    bit identical output, only previously-unseen rows touch the kernel.
    ``grid`` sets the kernel's hierarchical (coarse, fine) sweep sizes;
    ``cache=None`` means the global cache when deduping.
    """
    device = resolve_device(device)
    cols = [np.asarray(f, np.float32) for f in params.astuple()]
    n = cols[0].shape[0]
    if interval_rows is not None:
        bounds = np.asarray(interval_rows, np.float32)
        if bounds.shape != (n, layout.N_BOUNDS):
            raise ValueError(f"interval_rows must be [n, {layout.N_BOUNDS}], "
                             f"got {bounds.shape}")
    else:
        bounds = np.asarray(interval.bounds(), np.float32)
    keys = solver_cache.build_keys(cols, allowed, readjust, bounds)

    def solve(km: np.ndarray) -> torch.Tensor:
        return dvfs_solve_matrix(km, grid=grid, device=device, block=False)

    if dedup:
        out = solver_cache.solve_rows(
            keys, solve, tag=kernel_tag(device, grid),
            cache=solver_cache.GLOBAL_CACHE if cache is None else cache)
    else:
        out = solver_cache.to_numpy(solve(keys))
    return solver_cache.rows_to_solution(out)
