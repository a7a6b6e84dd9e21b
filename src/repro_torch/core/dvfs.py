"""GPU/accelerator DVFS power, performance and energy models (paper Eq. 1-4).

The paper models a DVFS-scalable accelerator with three normalized knobs:

  * ``V``  - core voltage,
  * ``fc`` - core frequency, upper-bounded by the sublinear voltage curve
             ``fc <= g1(V) = sqrt((V - 0.5) / 2) + 0.5``,
  * ``fm`` - memory frequency (memory *voltage* scaling is dropped: it has a
             narrow range and negligible energy impact, paper S3.1.1).

Runtime power (Eq. 1)::

    P(V, fc, fm) = P0 + gamma * fm + c * V^2 * fc

Execution time (Eq. 2)::

    t(fc, fm) = D * (delta / fc + (1 - delta) / fm) + t0

Energy (Eq. 3/4)::

    E = P * t

The functions take torch tensors, numpy arrays or Python floats and follow
the dtype rules of the JAX package's ``jnp`` code with 64-bit mode off: an
expression of numpy operands stays numpy (so ``min_time`` on float64 host
params is float64, as there), a ``jnp`` function (``square``, ``sqrt``,
``maximum``) yields float32, and a numpy operand that meets a tensor is cast
to float32 first.  So the host-side helpers (the ``t_min`` floors, the
max-speed and default powers) give the reference's bits, and the device
solvers in :mod:`repro_torch.core.single_task` reuse the same formulas on
float32 CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

Array = Any


def as_f32(x) -> Any:
    """One operand in float32: tensors are cast in place of their device,
    exact Python ``float``/``int`` stay weak scalars, anything else (numpy
    arrays and numpy scalars, of any width) becomes a float32 CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.to(torch.float32)
    if type(x) in (float, int):
        return x
    return torch.from_numpy(np.array(x, np.float32, ndmin=0))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  torch's vectorized float32
    sqrt on the CPU is one ulp off for some inputs; taken through float64
    it rounds exactly, as ``jnp.sqrt`` and CUDA's ``sqrtf`` do."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


# ---------------------------------------------------------------------------
# Voltage/frequency curve.
# ---------------------------------------------------------------------------

# g1(V) = sqrt((V - A) / B) + C, fitted on the paper's Pascal platform with
# A = 0.5, B = 2.0, C = 0.5 (S5.1.1).
G1_A = 0.5
G1_B = 2.0
G1_C = 0.5


def g1(v: Array) -> torch.Tensor:
    """Maximum core frequency allowed at core voltage ``v`` (sublinear)."""
    v = torch.as_tensor(as_f32(v), dtype=torch.float32)
    return sqrt(torch.clamp(v - G1_A, min=0.0) / G1_B) + G1_C


def g1_float(v: float) -> float:
    """Pure-python g1 for static uses such as interval bounds."""
    return math.sqrt(max(v - G1_A, 0.0) / G1_B) + G1_C


def g1_inv(fc: Array) -> torch.Tensor:
    """Minimum core voltage able to sustain core frequency ``fc``."""
    fc = torch.as_tensor(as_f32(fc), dtype=torch.float32)
    return G1_B * torch.square(torch.clamp(fc - G1_C, min=0.0)) + G1_A


# ---------------------------------------------------------------------------
# Scaling intervals (paper S5.1.1).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScalingInterval:
    """Normalized DVFS box ``V in [v_min, v_max], fm in [fm_min, fm_max],
    fc in [fc_min, g1(V)]``."""

    v_min: float
    v_max: float
    fc_min: float
    fm_min: float
    fm_max: float

    @property
    def fc_max(self) -> float:
        return g1_float(self.v_max)

    def bounds(self) -> tuple:
        """``(v_min, v_max, fc_min, fm_min, fm_max)`` — the per-row interval
        columns (``layout.BOUNDS_SLICE``, width ``layout.N_BOUNDS``) of the
        widened ``[n, NCOL]`` kernel task matrix."""
        return (self.v_min, self.v_max, self.fc_min, self.fm_min, self.fm_max)

    def clamp(self, v: Array, fc: Array, fm: Array):
        v = torch.clamp(torch.as_tensor(as_f32(v), dtype=torch.float32),
                        self.v_min, self.v_max)
        fc = torch.minimum(torch.clamp(torch.as_tensor(as_f32(fc),
                                                       dtype=torch.float32),
                                       min=self.fc_min), g1(v))
        fm = torch.clamp(torch.as_tensor(as_f32(fm), dtype=torch.float32),
                         self.fm_min, self.fm_max)
        return v, fc, fm


# The *analytical* ("Wide") interval used for the simulations: the paper argues
# for studying the potential of DVFS with fc_max = g1(1.2) ~= 1.0916.
WIDE = ScalingInterval(v_min=0.5, v_max=1.2, fc_min=0.5, fm_min=0.5, fm_max=1.2)

# The realistic ("Narrow") GTX-1080Ti interval.
NARROW = ScalingInterval(v_min=0.8, v_max=1.24, fc_min=0.89, fm_min=0.8, fm_max=1.1)

# Default (normalized) operating point: V = fc = fm = 1.
DEFAULT_SETTING = (1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# Task DVFS parameters.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DvfsParams:
    """Per-task model constants. Every field may be a scalar or an array of
    shape ``[n]`` (a batch of tasks); the host layers keep numpy float64
    arrays, the solvers convert to float32 tensors on their device.

    ``p0``    - frequency-independent power (static + host share), Watts.
    ``gamma`` - memory-frequency power sensitivity, Watts per normalized fm.
    ``c``     - core dynamic-power coefficient (``c * V^2 * fc``), Watts.
    ``big_d`` - frequency-sensitive execution-time component ``D``, seconds.
    ``delta`` - core-frequency sensitivity in ``[0, 1]``.
    ``t0``    - frequency-insensitive execution-time component, seconds.
    """

    p0: Array
    gamma: Array
    c: Array
    big_d: Array
    delta: Array
    t0: Array

    def astuple(self):
        return (self.p0, self.gamma, self.c, self.big_d, self.delta, self.t0)

    @property
    def n(self) -> int:
        return int(np.shape(np.asarray(self.p0))[0]) if np.ndim(self.p0) else 1

    def default_power(self) -> torch.Tensor:
        """P* = P(1, 1, 1), a float32 tensor."""
        return power(self, 1.0, 1.0, 1.0)

    def default_time(self) -> Array:
        """t* = t(1, 1) = D + t0, in the fields' own precision."""
        return self.big_d + self.t0

    def default_energy(self) -> torch.Tensor:
        return self.default_power() * as_f32(self.default_time())

    def __getitem__(self, idx) -> "DvfsParams":
        return DvfsParams(*(np.asarray(f)[idx] for f in self.astuple()))

    @staticmethod
    def stack(items) -> "DvfsParams":
        cols = list(zip(*(it.astuple() for it in items)))
        return DvfsParams(*(np.asarray(col, dtype=np.float64) for col in cols))


def _mixed(*xs):
    """Operands of one arithmetic expression under the JAX package's rule:
    numpy operands meet each other in numpy (float64 stays float64), but
    once a tensor is among them every numpy operand is cast to float32, as
    ``jnp`` does with 64-bit mode off."""
    if any(isinstance(x, torch.Tensor) for x in xs):
        return tuple(as_f32(x) for x in xs)
    return xs


def power(params: DvfsParams, v: Array, fc: Array, fm: Array) -> Array:
    """Runtime power, Eq. (1).  The ``V^2`` term is a float32 square (the
    reference's ``jnp.square``), so the result is always a float32 tensor;
    ``P0 + gamma fm`` is summed first in the operands' own precision."""
    p0, gamma, fm = _mixed(params.p0, params.gamma, fm)
    sq = torch.square(torch.as_tensor(as_f32(v), dtype=torch.float32))
    return as_f32(p0 + gamma * fm) + as_f32(params.c) * sq * as_f32(fc)


def exec_time(params: DvfsParams, fc: Array, fm: Array) -> Array:
    """Execution time, Eq. (2): numpy in, numpy out (float64 host floors),
    tensor in, float32 tensor out."""
    big_d, delta, t0, fc, fm = _mixed(params.big_d, params.delta, params.t0,
                                      fc, fm)
    return big_d * (delta / fc + (1.0 - delta) / fm) + t0


def energy(params: DvfsParams, v: Array, fc: Array, fm: Array) -> torch.Tensor:
    """Task energy, Eq. (4): E = P * t."""
    return power(params, v, fc, fm) * as_f32(exec_time(params, fc, fm))


def min_time(params: DvfsParams, interval: ScalingInterval) -> Array:
    """The fastest achievable execution time inside the scaling box."""
    return exec_time(params, interval.fc_max, interval.fm_max)


def optimal_fm(params: DvfsParams, v: Array, fc: Array,
               interval: ScalingInterval) -> torch.Tensor:
    """Closed-form optimal memory frequency for fixed (V, fc), paper S4.1.

    f_xi = sqrt((P0 + c V^2 fc) * D (1-delta) / (gamma * (t0 + D delta / fc))),
    clamped to [fm_min, fm_max].  gamma == 0 or delta == 1 degenerate to
    fm_min (memory frequency does not help time, only costs power).
    """
    sq = torch.square(torch.as_tensor(as_f32(v), dtype=torch.float32))
    num = ((as_f32(params.p0) + as_f32(params.c) * sq * as_f32(fc))
           * as_f32(params.big_d) * as_f32(1.0 - params.delta))
    gamma, t0, big_d, delta, fc_ = _mixed(params.gamma, params.t0,
                                          params.big_d, params.delta, fc)
    den = as_f32(gamma * (t0 + big_d * delta / fc_))
    f_xi = sqrt(num / torch.clamp(den, min=1e-30))
    # gamma==0: power is flat in fm while time decreases => fm_max optimal.
    f_xi = torch.where(torch.as_tensor(as_f32(params.gamma)) <= 0.0,
                       interval.fm_max, f_xi)
    return torch.clamp(f_xi, interval.fm_min, interval.fm_max)


# ---------------------------------------------------------------------------
# TPU adaptation constants.
#
# The scheduler's task abstraction is hardware-agnostic; these constants give
# the fleet simulation a v5e-class flavour.  They back the ``tpu-v5e`` machine
# class in :mod:`repro_torch.core.machines`.  Normalized exactly like the GPU
# numbers.
# ---------------------------------------------------------------------------

# Normalized DVFS box of the v5e-class part: a narrower voltage range than
# the analytic GPU interval (server silicon is binned tighter) with HBM
# frequency scaling down to 0.6 of nominal.
TPU_V5E_INTERVAL = ScalingInterval(v_min=0.7, v_max=1.1, fc_min=0.6,
                                   fm_min=0.6, fm_max=1.05)

TPU_V5E_CHIP = dict(
    # Peak board power envelope per chip (W), static + host share, HBM share,
    # and core dynamic share at the default operating point.
    p_peak=200.0,
    p0_frac=0.30,     # host/static/interconnect share
    gamma_frac=0.15,  # HBM-frequency-proportional share
    # remainder is c * V^2 * fc at (1,1,1)
    p_idle=37.0,      # idle pair power (kept identical to the paper's setup)
    delta_on=90.0,    # turn on/off energy overhead (J), paper S5.1.2
)
