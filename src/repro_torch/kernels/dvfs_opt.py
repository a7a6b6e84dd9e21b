"""The batched single-task DVFS optimum (paper §4.1) as a CUDA kernel.

This is the scheduler's own hot spot: Algorithm 1 solves
``argmin E(V, fc, fm)`` for every task on every machine class — hundreds of
thousands of independent 2-variable minimizations a simulated day.  The
hand-written kernel in ``csrc/dvfs_opt.cu`` replaces the JAX package's
Pallas TPU kernel ``repro/kernels/dvfs_opt.py::_kernel`` (with its
``_hier_argmin``), launched there by ``dvfs_solve_kernel``.

Layout: tasks are a ``[n, NCOL=16]`` f32 matrix whose columns are declared
once in :mod:`repro_torch.kernels.layout`
    (P0, GAMMA, C_COEF, BIG_D, DELTA, T0, ALLOWED, READJUST,
     V_MIN, V_MAX, FC_MIN, FM_MIN, FM_MAX, pad, pad, pad);
the ``BOUNDS_SLICE`` columns carry each row's own scaling box, so one
launch solves a class-stacked ``[C*n, 16]`` matrix.  The legacy
``[n, LEGACY_NCOL=8]`` layout is widened from a static ``interval``.  The
output is ``[n, 8]``: (v, fc, fm, t, p, e, deadline_prior, feasible).

Each row runs two **hierarchical** 1-D sweeps (``grid=(G0, G1)``, default
``(64, 64)``): ``G0`` coarse points bracket the argmin, ``G1`` fine points
re-sweep the ``±1``-coarse-step bracket, and the fine winner is kept only
if it is no worse than the coarse one.

* unconstrained: fc over [fc_min, g1(v_max)]; V = max(v_min, g1⁻¹(fc));
  fm = the closed-form optimum clamped to the box;
* deadline boundary: fm over its box; fc from t(fc, fm) = allowed;
  ``INF = 1e30`` energy where infeasible.

Then the decision rule of ``single_task.solve_with_deadline`` /
``solve_on_boundary``: energy-prior unless the row is a θ-readjustment or
its unconstrained optimum misses the window; max speed if infeasible.

Three functions compute it:

* :func:`dvfs_solve_plain` — the plain torch version, a line-for-line
  rendering of the Pallas body on ``[n, G]`` tensors (any device);
* :func:`dvfs_solve_cuda` — the CUDA kernel's wrapper, for CUDA tensors
  only; it counts its launches in ``dvfs_solve_cuda.launches``;
* :func:`dvfs_solve_kernel` — the dispatcher the solver stack calls: a CPU
  tensor goes to the plain version, a CUDA tensor to the kernel (or an
  error); there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.dvfs import G1_A, G1_B, G1_C, WIDE, ScalingInterval, sqrt
from repro_torch.kernels import build
from repro_torch.kernels.layout import (ALLOWED, BIG_D, C_COEF, DELTA, FC_MIN,
                                        FM_MAX, FM_MIN, GAMMA, KEY_COLS,
                                        LEGACY_NCOL, N_BOUNDS, NCOL, P0,
                                        READJUST, SOL_COLS, T0, V_MAX, V_MIN,
                                        col)

BT = 128   # tasks per CUDA block (one thread per task row)
DEFAULT_GRID = (64, 64)  # (coarse, fine) sweep points
INF = 1e30

#: A benign, fully-feasible pad task: reference-ish constants on the WIDE
#: box with a huge deadline window, so a pad row always takes the smooth
#: energy-prior branch.  The kernel masks its ragged edge and never needs
#: pad rows; a split of one matrix across several cards pads with these.
PAD_ROW = np.asarray(
    [[1.0, 1.0, 1.0, 1.0, 0.5, 0.1, 1e6, 0.0, *WIDE.bounds(), 0.0, 0.0, 0.0]],
    np.float32)
assert PAD_ROW.shape == (1, NCOL)


def _check_grid(grid) -> tuple:
    g0, g1 = int(grid[0]), int(grid[1])
    if g0 < 2 or g1 < 2:
        raise ValueError(f"grid sizes must be >= 2, got {grid}")
    return g0, g1


# ---------------------------------------------------------------------------
# The plain version.
# ---------------------------------------------------------------------------


def _g1(v):
    return sqrt(torch.clamp(v - G1_A, min=0.0) / G1_B) + G1_C


def _g1_inv(fc):
    return G1_B * torch.square(torch.clamp(fc - G1_C, min=0.0)) + G1_A


def _iota_frac(g: int, device) -> torch.Tensor:
    """``[g]`` fractions ``i / (g - 1)``, each an IEEE float32 division.
    The divisor is a device tensor on purpose: PyTorch computes a CUDA
    tensor divided by a Python scalar as a product with the reciprocal,
    which rounds differently from the kernel's (and the reference's)
    division."""
    return (torch.arange(g, dtype=torch.float32, device=device)
            / torch.tensor(float(g - 1), device=device))


def _hier_argmin(efn, n: int, g0: int, g1: int, device) -> torch.Tensor:
    """Coarse-then-fine argmin of ``efn`` over the unit interval.

    ``efn`` maps a fraction tensor ``[n, k]`` to energies ``[n, k]``.
    Sweeps ``g0`` coarse points, brackets the winner one coarse step to
    each side, re-sweeps ``g1`` fine points inside the bracket, and
    returns the per-row winning fraction ``[n]`` — guarded so the fine
    winner is never worse than the coarse one (refinement is monotone).
    """
    rows = torch.arange(n, device=device)
    f0 = _iota_frac(g0, device).expand(n, g0)
    e0 = efn(f0)
    i0 = torch.argmin(e0, dim=1)          # first index on ties, as jnp
    e0_best = e0[rows, i0]
    f0_best = f0[rows, i0]
    step = 1.0 / (g0 - 1)
    f_lo = torch.clamp((i0.to(torch.float32) - 1.0) * step, 0.0, 1.0)
    f_hi = torch.clamp((i0.to(torch.float32) + 1.0) * step, 0.0, 1.0)
    frac = _iota_frac(g1, device)
    f1 = f_lo[:, None] + (f_hi - f_lo)[:, None] * frac
    e1 = efn(f1)
    i1 = torch.argmin(e1, dim=1)
    e1_best = e1[rows, i1]
    f1_best = f1[rows, i1]
    return torch.where(e1_best <= e0_best, f1_best, f0_best)


def dvfs_solve_plain(tasks: torch.Tensor,
                     grid: tuple = DEFAULT_GRID) -> torch.Tensor:
    """The kernel's function in plain torch: ``[n, 16]`` f32 -> ``[n, 8]``.

    Follows the Pallas body (``repro/kernels/dvfs_opt.py``, ``_kernel`` and
    ``_hier_argmin``) operation for operation, on all ``n`` rows at once
    instead of one ``BT``-row block per grid step (rows are independent, so
    no pad rows are needed).  Runs on any device; the tests hold it against
    the Pallas kernel in interpret mode and the card holds the CUDA kernel
    against it.
    """
    g0, g1 = _check_grid(grid)
    t = tasks.to(torch.float32)                          # [n, NCOL]
    n, device = t.shape[0], t.device
    p0, gamma, cc = t[:, col(P0)], t[:, col(GAMMA)], t[:, col(C_COEF)]
    dd, delta, t0 = t[:, col(BIG_D)], t[:, col(DELTA)], t[:, col(T0)]
    allowed = t[:, col(ALLOWED)]
    readjust = t[:, READJUST] > 0.5  # theta-readjustment rows: boundary binds
    # Per-row scaling-interval bounds, shape [n, 1].
    v_min, v_max = t[:, col(V_MIN)], t[:, col(V_MAX)]
    fc_min, fm_min, fm_max = (t[:, col(FC_MIN)], t[:, col(FM_MIN)],
                              t[:, col(FM_MAX)])

    def energy_at(v, fc, fm):
        pw = p0 + gamma * fm + cc * torch.square(v) * fc
        tt = dd * (delta / fc + (1.0 - delta) / fm) + t0
        return pw * tt, pw, tt

    # ---- sweep 1: unconstrained, fc grid on [fc_min, g1(v_max)].
    fc_max = _g1(v_max)                                  # [n, 1]

    def unc_at(frac):
        """frac [n, k] -> (energy, (v, fc, fm, t)) on the optimal-V /
        closed-form-fm manifold (paper §4.1)."""
        fc = fc_min + (fc_max - fc_min) * frac           # [n, k]
        v = torch.maximum(v_min, _g1_inv(fc))
        # closed-form fm (paper §4.1), clamped; gamma == 0 -> fm_max.
        num = (p0 + cc * torch.square(v) * fc) * dd * (1.0 - delta)
        den = gamma * (t0 + dd * delta / fc)
        fm = sqrt(num / torch.clamp(den, min=1e-30))
        fm = torch.where(gamma <= 0.0, fm_max, fm)
        fm = torch.minimum(torch.maximum(fm, fm_min), fm_max)
        e, _, tt = energy_at(v, fc, fm)
        return e, (v, fc, fm, tt)

    fu = _hier_argmin(lambda f: unc_at(f)[0], n, g0, g1, device)
    _, (v_1, fc_1, fm_1, t_1) = unc_at(fu[:, None])      # [n, 1] at winner
    v_u, fc_u, fm_u, t_un = v_1[:, 0], fc_1[:, 0], fm_1[:, 0], t_1[:, 0]

    # ---- sweep 2: deadline boundary t(fc, fm) = allowed, fm grid.
    def bnd_at(frac):
        """frac [n, k] -> (energy, (v, fc, fm)) on the t = allowed
        manifold; infeasible points get INF."""
        fm2 = fm_min + (fm_max - fm_min) * frac
        slack = allowed - t0 - dd * (1.0 - delta) / fm2
        fc_req = dd * delta / torch.clamp(slack, min=1e-30)
        fc_req = torch.where(delta <= 0.0, fc_min, fc_req)
        bad = (slack <= 0.0) & (delta > 0.0)
        fc2 = torch.minimum(torch.maximum(fc_req, fc_min), fc_max)
        v2 = torch.maximum(v_min, _g1_inv(fc2))
        e, _, _ = energy_at(v2, fc2, fm2)
        e = torch.where(bad | (fc_req > fc_max + 1e-6), INF, e)
        return e, (v2, fc2, fm2)

    fb = _hier_argmin(lambda f: bnd_at(f)[0], n, g0, g1, device)
    _, (v_2, fc_2, fm_2) = bnd_at(fb[:, None])
    v_d, fc_d, fm_d = v_2[:, 0], fc_2[:, 0], fm_2[:, 0]

    # ---- decision rule (== solve_with_deadline / solve_on_boundary):
    # energy-prior if the unconstrained optimum meets the deadline;
    # readjust rows shrank their window below the optimum, so the boundary
    # binds by construction; infeasible (deadline < t_min) -> max speed.
    allowed1 = allowed[:, 0]
    energy_prior = (t_un <= allowed1 + 1e-6) & ~readjust
    t_min = (dd * (delta / fc_max + (1.0 - delta) / fm_max) + t0)[:, 0]
    feasible = allowed1 >= t_min - 1e-6

    def pick(unc, con, mx):
        x = torch.where(energy_prior, unc, con)
        return torch.where(feasible, x, mx)

    vf = pick(v_u, v_d, v_max[:, 0])
    fcf = pick(fc_u, fc_d, fc_max[:, 0])
    fmf = pick(fm_u, fm_d, fm_max[:, 0])
    p0_, gamma_, cc_ = p0[:, 0], gamma[:, 0], cc[:, 0]
    dd_, delta_, t0_ = dd[:, 0], delta[:, 0], t0[:, 0]
    pw = p0_ + gamma_ * fmf + cc_ * torch.square(vf) * fcf
    tt = dd_ * (delta_ / fcf + (1.0 - delta_) / fmf) + t0_
    tt = torch.where(feasible & ~energy_prior, torch.minimum(tt, allowed1), tt)

    # [n, SOL_COLS] in layout.SOL_* column order.
    return torch.stack([vf, fcf, fmf, tt, pw, pw * tt,
                        (~energy_prior).to(torch.float32),
                        feasible.to(torch.float32)], dim=1)


# ---------------------------------------------------------------------------
# The CUDA kernel.
# ---------------------------------------------------------------------------


def _library():
    """The built kernel library with its C signatures declared."""
    lib = build.load("dvfs_opt")
    if not getattr(lib, "_dvfs_opt_typed", False):
        lib.dvfs_opt_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.dvfs_opt_launch.restype = ctypes.c_int
        lib.dvfs_opt_error_string.argtypes = [ctypes.c_int]
        lib.dvfs_opt_error_string.restype = ctypes.c_char_p
        lib._dvfs_opt_typed = True
    return lib


def dvfs_solve_cuda(tasks: torch.Tensor,
                    grid: tuple = DEFAULT_GRID) -> torch.Tensor:
    """Launch ``csrc/dvfs_opt.cu`` on a contiguous ``[n, 16]`` f32 CUDA
    tensor; returns the ``[n, 8]`` solution tensor, still being computed on
    the current stream.  Builds the kernel with ``nvcc`` at first use.
    Raises on any other input, and if the launch is refused."""
    if not isinstance(tasks, torch.Tensor) or tasks.device.type != "cuda":
        raise ValueError("dvfs_solve_cuda takes a CUDA tensor; got "
                         f"{getattr(tasks, 'device', type(tasks).__name__)}")
    if tasks.dtype != torch.float32:
        raise TypeError(f"dvfs_solve_cuda takes float32, got {tasks.dtype}")
    if tasks.dim() != 2 or tasks.shape[1] != NCOL:
        raise ValueError(f"dvfs_solve_cuda takes [n, {NCOL}], got "
                         f"{tuple(tasks.shape)}")
    if not tasks.is_contiguous() or tasks.data_ptr() % 16:
        raise ValueError("dvfs_solve_cuda takes a contiguous, 16-byte "
                         "aligned matrix")
    g0, g1 = _check_grid(grid)
    n = tasks.shape[0]
    out = torch.empty((n, SOL_COLS), dtype=torch.float32, device=tasks.device)
    if n == 0:
        return out
    lib = _library()
    # The coarse step exactly as the reference rounds its Python float.
    step0 = float(np.float32(1.0 / (g0 - 1)))
    with torch.cuda.device(tasks.device):
        stream = torch.cuda.current_stream(tasks.device).cuda_stream
        rc = lib.dvfs_opt_launch(tasks.data_ptr(), out.data_ptr(), n, g0, g1,
                                 step0, stream)
    if rc != 0:
        raise RuntimeError("dvfs_opt kernel launch failed: "
                           + lib.dvfs_opt_error_string(rc).decode())
    dvfs_solve_cuda.launches += 1
    return out


dvfs_solve_cuda.launches = 0


def dvfs_solve_kernel(tasks: torch.Tensor, *,
                      interval: ScalingInterval = WIDE,
                      grid: tuple = DEFAULT_GRID) -> torch.Tensor:
    """tasks: ``[n, 8]`` or ``[n, 16]`` tensor -> ``[n, 8]`` (v, fc, fm, t,
    p, e, deadline_prior, feasible) on the same device.

    An 8-column matrix is widened with the static ``interval``'s bounds
    (the homogeneous legacy layout); a 16-column matrix carries per-row
    bounds and ignores ``interval``.  A CPU tensor is solved by
    :func:`dvfs_solve_plain`, a CUDA tensor by the CUDA kernel.
    """
    _check_grid(grid)
    n = tasks.shape[0]
    if tasks.shape[1] == LEGACY_NCOL:
        bounds = torch.tensor(interval.bounds(), dtype=tasks.dtype,
                              device=tasks.device).expand(n, N_BOUNDS)
        pad = torch.zeros((n, NCOL - KEY_COLS), dtype=tasks.dtype,
                          device=tasks.device)
        tasks = torch.cat([tasks, bounds, pad], dim=1)
    elif tasks.shape[1] != NCOL:
        raise ValueError(f"task matrix must have {LEGACY_NCOL} or {NCOL} "
                         f"columns, got {tasks.shape[1]}")
    if tasks.device.type == "cpu":
        return dvfs_solve_plain(tasks, grid)
    if tasks.device.type == "cuda":
        return dvfs_solve_cuda(tasks.to(torch.float32).contiguous(), grid)
    raise ValueError(f"no dvfs_opt solver for device {tasks.device}")
