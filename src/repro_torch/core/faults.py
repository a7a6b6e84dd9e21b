"""Server failure/recovery injection for the online event-driven stack.

The paper's online algorithms (Algorithms 4-6) assume every acquired server
survives until its DRS power-off event.  Real clusters lose nodes mid-job,
so this module adds failure semantics on top of the
:class:`~repro_torch.core.engine.ClusterEngine` without disturbing the
failure-free paths (every fault check in the engine is gated on a flag
that stays False until the first failure, so fault-free runs remain
bit-identical to the pre-fault goldens):

* :class:`FaultTrace` — a deterministic, state-independent list of
  :class:`FaultEvent` (server crash / recovery), built from an explicit
  event list (:meth:`FaultTrace.from_events`), exponential MTBF/MTTR
  alternation per server slot (:meth:`FaultTrace.sample`; pass an array
  ``mtbf`` for per-class rates), or a fixed fraction of servers
  (:meth:`FaultTrace.fraction`).  Traces name *server slots*: an event for
  a server the run never builds is counted and skipped, so one trace can
  replay against schedulers that open different fleet sizes.
* :class:`FaultInjector` — the runtime half, driven by
  :func:`repro_torch.core.online.schedule_online` between arrival groups.  At a
  crash it settles engine energy exactly at the failure instant
  (:meth:`~repro_torch.core.engine.ClusterEngine.fail_pairs` books idle/compute
  up to ``t``, never past it), truncates the orphaned in-flight records
  (energy up to ``t`` is *wasted* but still billed — the machine did burn
  it), tombstones queued-but-unstarted records, and re-enters the orphan
  tasks into placement with shrunken DVFS windows
  (:meth:`~repro_torch.core.placement.PlacementContext.place_orphans`, whose
  re-solves ride the same deferred ``readjust_batch`` dispatch as the
  θ-readjustments).  When no pair can meet a deadline the documented
  graceful-degradation policy books the task at max speed and lets the
  violation be counted — a failure trace can never crash a run.

Event ordering is deterministic: events sort by ``(t, kind, server)`` with
failures before recoveries at equal times; the simulation applies every
event with ``t <= slot`` before placing the slot's arrival group.

See docs/ARCHITECTURE.md (fault-injection layer) and docs/TESTING.md for
the failure-trace regression workflow.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_EPS = 1e-9

#: sort rank per event kind: failures apply before recoveries at equal t
_KIND_RANK = {"fail": 0, "revive": 1}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One server transition: the server crashes or comes back at ``t``."""

    t: float
    server: int
    kind: str  # "fail" | "revive"

    def __post_init__(self):
        if self.kind not in _KIND_RANK:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.t < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.server < 0:
            raise ValueError(f"server id must be >= 0, got {self.server}")


def _sort(events) -> Tuple[FaultEvent, ...]:
    return tuple(sorted(events,
                        key=lambda e: (e.t, _KIND_RANK[e.kind], e.server)))


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """A deterministic failure trace: time-sorted server fail/revive events.

    Traces are generated up front from a seed or an explicit list — they
    never depend on simulation state, so the same trace replays
    bit-identically against the scalar and vector placement paths (and
    against different schedulers, where events naming never-built servers
    are skipped)."""

    events: Tuple[FaultEvent, ...]

    def __len__(self) -> int:
        return len(self.events)

    @property
    def n_failures(self) -> int:
        return sum(1 for e in self.events if e.kind == "fail")

    @classmethod
    def from_events(cls, events: Sequence) -> "FaultTrace":
        """Build from FaultEvents or ``(t, server, kind)`` tuples; order
        does not matter (events are sorted deterministically)."""
        evs = [e if isinstance(e, FaultEvent) else FaultEvent(float(e[0]),
                                                              int(e[1]), e[2])
               for e in events]
        return cls(_sort(evs))

    @classmethod
    def sample(cls, n_servers: int, horizon: float, mtbf,
               mttr: Optional[float] = None, seed: int = 0) -> "FaultTrace":
        """Exponential MTBF/MTTR alternation per server slot.

        ``mtbf`` is the mean up-time before a crash — a scalar, or an array
        of length ``n_servers`` for per-slot rates (the per-*class* support:
        build the array from the server classes of a failure-free run, or
        from any class layout you want to model).  ``mttr`` is the mean
        repair time; ``None`` means crashed servers never come back.
        """
        rng = np.random.default_rng(seed)
        mtbf = np.broadcast_to(np.asarray(mtbf, np.float64), (int(n_servers),))
        if np.any(mtbf <= 0.0):
            raise ValueError("mtbf must be positive")
        events: List[FaultEvent] = []
        for sid in range(int(n_servers)):
            t = float(rng.exponential(mtbf[sid]))
            while t < horizon:
                events.append(FaultEvent(t, sid, "fail"))
                if mttr is None:
                    break
                t += max(float(rng.exponential(mttr)), 1e-3)
                if t >= horizon:
                    break
                events.append(FaultEvent(t, sid, "revive"))
                t += float(rng.exponential(mtbf[sid]))
        return cls(_sort(events))

    @classmethod
    def fraction(cls, n_servers: int, frac: float, horizon: float,
                 seed: int = 0,
                 repair: Optional[float] = None) -> "FaultTrace":
        """Crash a fixed fraction of the first ``n_servers`` server slots,
        each once, at a uniform random time in ``(0, horizon)``; with
        ``repair`` each comes back that many slots later.  The pinned-trace
        shape of the CI fault-tolerance smoke ("1% of pairs fail")."""
        n_servers = int(n_servers)
        k = min(n_servers, max(1, int(round(frac * n_servers))))
        rng = np.random.default_rng(seed)
        sids = rng.choice(n_servers, size=k, replace=False)
        times = rng.uniform(_EPS, horizon, size=k)
        events = [FaultEvent(float(t), int(s), "fail")
                  for t, s in zip(times, sids)]
        if repair is not None:
            events += [FaultEvent(float(t + repair), int(s), "revive")
                       for t, s in zip(times, sids)]
        return cls(_sort(events))


class FaultInjector:
    """Replays a :class:`FaultTrace` against a live online run.

    Owned by :func:`repro_torch.core.online.schedule_online`; the loop calls
    :meth:`advance` before each arrival group (applying every event up to
    the slot), :meth:`register` after each placement (tracking which
    assignment records live on which pair), and :meth:`finalize_records`
    once after the deferred readjust solves (re-pricing truncated records
    from their *final* power — a truncated θ-readjusted record only knows
    its power after the batch solve).

    ``stats`` counts ``failures`` / ``revivals`` applied, ``skipped``
    events (server never built, or already in the target state),
    ``orphans`` (records cut by a crash), ``restarted`` re-placements and
    ``degraded`` graceful-degradation bookings.
    """

    def __init__(self, eng, ctx, trace: FaultTrace, rule: str,
                 degrade: Optional[Callable] = None):
        self.eng = eng
        self.ctx = ctx
        self.events = list(trace.events)
        self.pos = 0
        self.rule = rule
        self.degrade = degrade
        self.pair_tasks: Dict[int, List[int]] = {}
        self.truncated: List[int] = []
        self.stats = {"failures": 0, "revivals": 0, "skipped": 0,
                      "orphans": 0, "restarted": 0, "degraded": 0}

    # -- tracking ------------------------------------------------------------
    def register(self, base: int):
        """Track ``assignments[base:]`` (one placement's records) by pair."""
        asn = self.ctx.assignments
        for i in range(base, len(asn)):
            self.pair_tasks.setdefault(asn[i].pair, []).append(i)

    # -- replay --------------------------------------------------------------
    def advance(self, t: float):
        """Apply every event with ``e.t <= t``, each at its exact time:
        settle the engine to ``e.t`` first, so a crash books energy at the
        failure instant and never past it."""
        while self.pos < len(self.events) \
                and self.events[self.pos].t <= t + _EPS:
            e = self.events[self.pos]
            self.pos += 1
            if e.server >= self.eng.n_servers:
                self.stats["skipped"] += 1
                continue
            self.eng.settle(e.t)
            if e.kind == "fail":
                self._fail(e)
            else:
                self._revive(e)

    def _fail(self, e: FaultEvent):
        l = self.eng.l
        lo = e.server * l
        pids = np.arange(lo, lo + l, dtype=np.int64)
        asn = self.ctx.assignments
        rollback = np.zeros(l)
        orphans: List[int] = []
        for j, pid in enumerate(pids.tolist()):
            rows = self.pair_tasks.get(pid)
            if not rows:
                continue
            for ai in rows:
                a = asn[ai]
                if a.failed or a.finish <= e.t + _EPS:
                    continue          # already truncated, or completed by t
                if a.start < e.t - _EPS:
                    # in-flight: the task dies mid-run; energy up to the
                    # crash is wasted but billed (the machine burned it)
                    rollback[j] += a.finish - e.t
                    asn[ai] = dataclasses.replace(a, finish=e.t, failed=True)
                else:
                    # queued but unstarted: tombstone (records are
                    # index-addressed by the pending readjust rows, so
                    # they are never removed, only zero-spanned)
                    rollback[j] += a.finish - a.start
                    asn[ai] = dataclasses.replace(a, finish=a.start,
                                                  failed=True)
                self.truncated.append(ai)
                orphans.append(a.task)
            rows.clear()              # pair is down: nothing left to track
        failed = self.eng.fail_pairs(e.t, pids, busy_rollback=rollback)
        if failed.size == 0:
            self.stats["skipped"] += 1
            return
        self.stats["failures"] += 1
        self.stats["orphans"] += len(orphans)
        if orphans:
            base = len(asn)
            restarted, degraded = self.ctx.place_orphans(
                np.asarray(orphans, dtype=np.int64), e.t, self.rule,
                degrade=self.degrade)
            self.stats["restarted"] += restarted
            self.stats["degraded"] += degraded
            self.register(base)

    def _revive(self, e: FaultEvent):
        l = self.eng.l
        lo = e.server * l
        revived = self.eng.revive_pairs(
            e.t, np.arange(lo, lo + l, dtype=np.int64))
        if revived.size:
            self.stats["revivals"] += 1
        else:
            self.stats["skipped"] += 1

    # -- post-pass -----------------------------------------------------------
    def finalize_records(self):
        """Re-price every truncated record as ``power * (finish - start)``.

        Runs AFTER :func:`repro_torch.core.scheduling.fill_readjusted`: a
        truncated θ-readjusted record gets its power from the deferred
        boundary solve, and the batch writer prices the full window — this
        pass rewrites the energy to the span the pair actually ran
        (tombstones price to exactly 0)."""
        asn = self.ctx.assignments
        for ai in self.truncated:
            a = asn[ai]
            asn[ai] = dataclasses.replace(
                a, energy=a.power * (a.finish - a.start))


def make_degrade(task_set, mcs, interval, use_dvfs: bool) -> Callable:
    """The graceful-degradation setting: ``degrade(task, class) ->
    (v, fc, fm, t, p)`` at the class's maximum speed (``t`` equals the
    class ``t_min`` bitwise — both are :func:`repro_torch.core.dvfs.min_time` on
    the adapted params), or the ``(1, 1, 1)`` default when DVFS is off.
    Lazy per class: fault recovery is a rare path."""
    from repro_torch.core import single_task

    cache: Dict[int, tuple] = {}

    def degrade(g: int, c: int):
        if c not in cache:
            params_c = mcs[c].adapt(task_set.params)
            if use_dvfs:
                iv = mcs[c].effective_interval(interval)
                cache[c] = single_task.max_speed_setting(params_c, iv)
            else:
                t = np.asarray(params_c.default_time(), np.float64)
                p = np.asarray(params_c.default_power(), np.float64)
                ones = np.ones_like(t)
                cache[c] = (ones, ones, ones, t, p)
        v, fc, fm, t, p = cache[c]
        return (float(v[g]), float(fc[g]), float(fm[g]), float(t[g]),
                float(p[g]))

    return degrade
