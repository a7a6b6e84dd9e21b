"""Accelerator-job adapter: LM training/serving jobs as paper-model tasks.

A copy of the JAX package's ``core/jobs.py`` (numpy and ``core/dvfs.py``
only; it imports nothing of JAX).  This is the hardware adaptation of the
paper's central abstraction: the schedulable unit becomes a non-preemptive
*LM job* (train N steps of an architecture x shape cell, or serve a request
batch) running on one accelerator slice, and the job's DVFS model
parameters are **derived from the roofline analysis of the compiled
dry-run** instead of a profiling pass:

* ``delta`` (core-frequency sensitivity) := T_compute / (T_compute + T_memory)
  - a compute-bound cell (dense 4k training) is core-voltage sensitive, a
  memory-bound cell (32k decode) is HBM-frequency sensitive;
* ``t*`` (default duration) := steps x max(roofline terms) at the default
  operating point, plus a frequency-insensitive ``t0`` share (host input
  pipeline, collective latency floor);
* the power split ``(P0, gamma, c)`` comes from the chip envelope
  (:data:`repro_torch.core.dvfs.TPU_V5E_CHIP`).

The resulting :class:`repro_torch.core.tasks.TaskSet` is scheduled by the
*same* EDL theta-readjustment algorithms as the paper's GPU tasks - the scheduler
is architecture-agnostic; only the fitted constants differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core import dvfs
from repro_torch.core.dvfs import TPU_V5E_CHIP, DvfsParams
from repro_torch.core.tasks import TaskSet


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-step roofline terms (seconds) of one compiled (arch x shape) cell."""

    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def step_time(self) -> float:
        """Roofline step-time estimate: the max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def delta(self) -> float:
        """Compute-boundness, the paper's core-frequency sensitivity."""
        denom = self.compute_s + self.memory_s
        return float(self.compute_s / denom) if denom > 0 else 0.5

    @property
    def bottleneck(self) -> str:
        terms = dict(compute=self.compute_s, memory=self.memory_s,
                     collective=self.collective_s)
        return max(terms, key=terms.get)


@dataclasses.dataclass(frozen=True)
class AcceleratorJob:
    """A non-preemptive accelerator job: N steps of one (arch x shape) cell."""

    arch: str
    shape: str
    steps: int
    arrival: float            # slot units
    deadline_slack: float     # deadline = arrival + slack * t_star
    terms: RooflineTerms
    t0_frac: float = 0.10     # host/io share that does not scale with DVFS

    @property
    def t_star(self) -> float:
        return self.steps * self.terms.step_time  # seconds

    def to_params(self, chip: dict = TPU_V5E_CHIP) -> DvfsParams:
        """Paper-model constants for this job.

        The collective share of the step joins ``t0`` (ICI frequency is not a
        DVFS knob on the modeled part), so a collective-bound job is correctly
        seen by the scheduler as nearly frequency-insensitive.
        """
        step = self.terms.step_time
        coll_frac = self.terms.collective_s / step if step > 0 else 0.0
        t0_frac = min(0.95, max(self.t0_frac, coll_frac))
        return dvfs.tpu_task_params(self.t_star, self.terms.delta,
                                    t0_frac=t0_frac, chip=chip)


def jobs_to_task_set(jobs: Sequence[AcceleratorJob],
                     chip: dict = TPU_V5E_CHIP) -> TaskSet:
    """Convert accelerator jobs into a schedulable :class:`TaskSet` (float64
    host arrays, as the reference builds them)."""
    params = DvfsParams.stack([j.to_params(chip) for j in jobs])
    arrival = np.asarray([j.arrival for j in jobs], dtype=np.float64)
    t_star = np.asarray(params.default_time())
    deadline = arrival + np.asarray([j.deadline_slack for j in jobs]) * t_star
    # Utilization bookkeeping mirrors the paper's generator: u = t*/(d - a).
    util = t_star / np.maximum(deadline - arrival, 1e-9)
    return TaskSet(arrival=arrival, deadline=deadline, params=params,
                   utilization=util)


def synth_job_stream(terms_table: Dict[str, RooflineTerms], n_jobs: int,
                     horizon: int = 1440, seed: int = 0,
                     steps_range=(50, 500),
                     slack_range=(1.1, 3.0)) -> List[AcceleratorJob]:
    """A day of mixed training/serving jobs drawn from a roofline table.

    ``terms_table`` maps "arch/shape" cell names to their measured roofline
    terms (the JAX package's ``benchmarks/roofline.py`` produces them from
    its dry-runs); arrivals are uniform over
    the horizon with an offline batch at slot 0.
    """
    rng = np.random.default_rng(seed)
    cells = sorted(terms_table)
    out: List[AcceleratorJob] = []
    for i in range(n_jobs):
        cell = cells[int(rng.integers(len(cells)))]
        arch, shape = cell.split("/", 1)
        arrival = 0.0 if i < max(1, n_jobs // 8) else float(rng.integers(1, horizon))
        out.append(AcceleratorJob(
            arch=arch, shape=shape,
            steps=int(rng.integers(*steps_range)),
            arrival=arrival,
            deadline_slack=float(rng.uniform(*slack_range)),
            terms=terms_table[cell]))
    return sorted(out, key=lambda j: j.arrival)
