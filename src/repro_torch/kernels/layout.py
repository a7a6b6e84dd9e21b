"""THE declared column schema of the DVFS solver matrices.

Three hand-synchronized matrix layouts flow through the solver stack —
the ``[n, NCOL]`` kernel *task* matrix (:mod:`repro_torch.kernels.dvfs_opt`),
the ``[n, KEY_COLS]`` solver-cache *key* matrix
(:mod:`repro_torch.core.solver_cache`, = task columns ``0..KEY_COLS-1``) and
the ``[n, SOL_COLS]`` *solution* matrix every solver returns.  This
module is the single place their column meanings are declared; every
other module indexes them through these names, so the three layouts
cannot drift apart silently.  It is a copy of the JAX package's schema
(``tests/test_torch_layout.py`` holds the two equal), and the CUDA
kernel's row offsets in ``csrc/dvfs_opt.cu`` follow it.

Imports nothing (stdlib ``typing`` only), so any layer — kernels, the
solver cache, the core solvers, tools — can depend on it without cycles.

Task matrix (one row per task; f32)::

    col   0..5   P0, GAMMA, C_COEF, BIG_D, DELTA, T0   DvfsParams columns
    col   6      ALLOWED                               time budget d - a
    col   7      READJUST                              >0.5: boundary binds
    col   8..12  V_MIN, V_MAX, FC_MIN, FM_MIN, FM_MAX  per-row interval box
    col  13..15  padding to NCOL (four 16-byte loads per row)

Columns ``0..KEY_COLS-1`` ARE the solver-cache key: the f32 row is the
entire solver input, which is what makes unique-row dedup bit-transparent.

Solution matrix (one row per task; f32, bools stored as 0.0/1.0)::

    col   0..7   SOL_V, SOL_FC, SOL_FM, SOL_T, SOL_P, SOL_E,
                 SOL_DP (deadline_prior), SOL_FEASIBLE
"""

from __future__ import annotations

from typing import Any, NamedTuple

# --- task / key matrix columns -------------------------------------------
P0, GAMMA, C_COEF, BIG_D, DELTA, T0, ALLOWED, READJUST = range(8)
V_MIN, V_MAX, FC_MIN, FM_MIN, FM_MAX = range(8, 13)

N_PARAMS = 6        #: DvfsParams columns (P0..T0)
N_BOUNDS = 5        #: ScalingInterval.bounds() columns (V_MIN..FM_MAX)
LEGACY_NCOL = 8     #: the homogeneous [n, 8] layout: params+allowed+readjust
KEY_COLS = 13       #: solver-cache key width = params+allowed+readjust+bounds
NCOL = 16           #: kernel task-matrix width (KEY_COLS + 3 pad columns)

PARAMS_SLICE = slice(0, N_PARAMS)         #: the DvfsParams columns
BOUNDS_SLICE = slice(V_MIN, KEY_COLS)     #: the per-row interval columns

# --- solution matrix columns ---------------------------------------------
SOL_V, SOL_FC, SOL_FM, SOL_T, SOL_P, SOL_E, SOL_DP, SOL_FEASIBLE = range(8)
SOL_COLS = 8        #: solution width (= the DvfsSolution fields, in order)

# Width asserts tying the three layouts together: the key matrix is a
# prefix of the task matrix, and both derive from the same column names.
assert N_PARAMS + 2 == READJUST + 1 == LEGACY_NCOL
assert LEGACY_NCOL + N_BOUNDS == FM_MAX + 1 == KEY_COLS
assert KEY_COLS <= NCOL
assert SOL_FEASIBLE + 1 == SOL_COLS


def col(i: int) -> slice:
    """Width-1 column slice ``[i, i+1)`` — a keepdims column read."""
    return slice(i, i + 1)


class DvfsSolution(NamedTuple):
    """Optimal DVFS setting for a (batch of) task(s) — the record form of
    the solution matrix, fields in ``SOL_*`` column order.

    Declared here (not in :mod:`repro_torch.core.single_task`, which re-exports
    it) so the solver-throughput layer and the kernel wrappers can name
    the solution type without importing up-layer.
    """

    v: Any
    fc: Any
    fm: Any
    time: Any
    power: Any
    energy: Any
    deadline_prior: Any  # bool: was the deadline binding?
    feasible: Any        # bool: can the deadline be met at all?


assert len(DvfsSolution._fields) == SOL_COLS
