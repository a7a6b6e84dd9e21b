"""Vectorized cluster state machine shared by every scheduler (§3.1.2, §4.2).

``ClusterEngine`` is the single source of truth for cluster state: pair
finish times (``mu``), cumulative busy time and the pair's *machine class*
are flat numpy arrays, and server DRS bookkeeping (on/off, powered-on
duration, turn-on counts, server class) is a parallel set of arrays with
pairs laid out contiguously per server (``server j`` owns pairs
``[j*l, (j+1)*l)``).  Servers are class-homogeneous: every pair of a server
shares its ``class_id``, so the DRS sweep and the Eq. (7) sums naturally
operate per class.  The offline (Algorithms 1-3) and online (Algorithms
4-6) schedulers in :mod:`repro_torch.core.scheduling` and :mod:`repro_torch.core.online`
are thin policy layers over this engine: they pick pairs via the vectorized
``worst_fit`` / ``best_fit`` / ``first_fit`` selectors (optionally
restricted to one class) and never touch the arrays directly.

Heterogeneity: pass ``classes`` (a sequence of
:class:`repro_torch.core.machines.MachineClass`, or any objects with ``p_idle``
and ``delta_on`` attributes) and open pairs/servers with a ``class_id``.
With the default single class the engine reduces exactly to the homogeneous
paper setup (scalar ``p_idle``/``delta_on``).

Two operating modes share the arrays and the Eq. (7) finalizer:

* ``servers=False`` (offline): pairs are opened on demand with no live
  server bookkeeping; :meth:`finalize` runs Algorithm 3 — per class, sort
  pairs by finish time, group ``l`` consecutive pairs into a *virtual*
  server whose powered-on span is its longest pair — and then evaluates the
  same Eq. (7) sum with ``omega = 0``, which is exactly Eq. (6).
* ``servers=True`` (online): pairs come in server granules of ``l``; DRS
  power-off is an *event*: a server goes off exactly ``rho`` slots after
  its last pair frees up, and :meth:`settle` books every such event at
  its exact time ``mu_srv + rho`` no matter how far past it the
  simulation has advanced (arrival slots may be arbitrarily sparse).
  Every power-on adds ``l`` to the turn-on count ``omega``.
  :meth:`finalize` settles the stragglers through the same primitive and
  returns (per class ``k``)

      E_idle     = sum_k P_idle[k] * (sum_j on_time_jk * l - sum busy_k)
      E_overhead = sum_k Delta[k] * omega_k.

See docs/EQUATIONS.md for the full equation/algorithm -> code map.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import cluster as cl

_EPS = 1e-9


class _DefaultClass:
    """Scalar-parameter stand-in when no machine classes are given."""

    __slots__ = ("name", "p_idle", "delta_on")

    def __init__(self, p_idle: float, delta_on: float):
        self.name = "default"
        self.p_idle = p_idle
        self.delta_on = delta_on


class ClusterEngine:
    """Struct-of-arrays pair/server state with vectorized policy selectors."""

    def __init__(self, l: int, *, servers: bool = True, rho: int = cl.RHO,
                 p_idle: float = cl.P_IDLE, delta_on: float = cl.DELTA_ON,
                 max_pairs: int = cl.MAX_PAIRS, classes: Sequence = None):
        self.l = int(l)
        self.server_mode = bool(servers)
        self.rho = rho
        self.classes = tuple(classes) if classes is not None \
            else (_DefaultClass(p_idle, delta_on),)
        self.max_pairs = max_pairs
        self.n_pairs = 0
        self.n_servers = 0
        cap_p, cap_s = 64, 16
        self._mu = np.zeros(cap_p)
        self._busy = np.zeros(cap_p)
        self._cls = np.zeros(cap_p, dtype=np.int64)
        self._on = np.zeros(cap_s, dtype=bool)
        self._on_since = np.zeros(cap_s)
        self._on_time = np.zeros(cap_s)
        self._turn_ons = np.zeros(cap_s, dtype=np.int64)
        self._srv_cls = np.zeros(cap_s, dtype=np.int64)
        # Server-level finish time max_k mu_{server pairs} maintained
        # incrementally (mu only ever moves forward), so settle() never
        # re-reduces the pair columns.
        self._mu_srv = np.zeros(cap_s)
        # Fault state (repro_torch.core.faults): failed pairs are ineligible, and
        # a server with a failed pair is withheld from the wake pool until
        # revived.  _any_failed gates every fast-path check so the
        # failure-free masks stay bit-identical to the pre-fault engine.
        self._pair_failed = np.zeros(cap_p, dtype=bool)
        self._srv_failed = np.zeros(cap_s, dtype=bool)
        self._any_failed = False
        # Dirty-pair tracking for incremental placement pools: with
        # ``track_offs`` on, settle() logs every server it powers off (the
        # pool owner deletes just those pair blocks instead of rebuilding),
        # and ``pool_epoch`` bumps on any fault transition — the coarse
        # invalidate-everything signal for prefetched pool state.
        self.track_offs = False
        self._off_log: list = []
        self.pool_epoch = 0

    # Back-compat scalar views (meaningful for the single-class engine).
    @property
    def p_idle(self) -> float:
        return self.classes[0].p_idle

    @property
    def delta_on(self) -> float:
        return self.classes[0].delta_on

    # -- array views ---------------------------------------------------------
    @property
    def mu(self) -> np.ndarray:
        """Finish time of the last task per pair, shape ``[n_pairs]``."""
        return self._mu[: self.n_pairs]

    @property
    def busy(self) -> np.ndarray:
        """Cumulative busy duration per pair, shape ``[n_pairs]``."""
        return self._busy[: self.n_pairs]

    @property
    def pair_class(self) -> np.ndarray:
        """Machine-class id per pair, shape ``[n_pairs]``."""
        return self._cls[: self.n_pairs]

    @property
    def feasible_pairs(self) -> bool:
        return self.n_pairs <= self.max_pairs

    def n_on_servers(self) -> int:
        return int(np.count_nonzero(self._on[: self.n_servers]))

    def server_class(self, sid: int) -> int:
        """Machine-class id of one server."""
        return int(self._srv_cls[sid])

    # -- growth --------------------------------------------------------------
    def _grow_pairs(self, extra: int):
        need = self.n_pairs + extra
        if need <= self._mu.shape[0]:
            return
        cap = max(need, 2 * self._mu.shape[0])
        pad = cap - self._mu.shape[0]
        self._mu = np.concatenate([self._mu, np.zeros(pad)])
        self._busy = np.concatenate([self._busy, np.zeros(pad)])
        self._cls = np.concatenate([self._cls, np.zeros(pad, dtype=np.int64)])
        self._pair_failed = np.concatenate(
            [self._pair_failed, np.zeros(pad, dtype=bool)])

    def _grow_servers(self, extra: int):
        need = self.n_servers + extra
        if need <= self._on.shape[0]:
            return
        cap = max(need, 2 * self._on.shape[0])
        pad = cap - self._on.shape[0]
        self._on = np.concatenate([self._on, np.zeros(pad, dtype=bool)])
        self._on_since = np.concatenate([self._on_since, np.zeros(pad)])
        self._on_time = np.concatenate([self._on_time, np.zeros(pad)])
        self._turn_ons = np.concatenate([self._turn_ons,
                                         np.zeros(pad, dtype=np.int64)])
        self._srv_cls = np.concatenate([self._srv_cls,
                                        np.zeros(pad, dtype=np.int64)])
        self._mu_srv = np.concatenate([self._mu_srv, np.zeros(pad)])
        self._srv_failed = np.concatenate(
            [self._srv_failed, np.zeros(pad, dtype=bool)])

    # -- transitions ---------------------------------------------------------
    def open_pair(self, mu0: float = 0.0, class_id: int = 0) -> int:
        """A fresh standalone pair (offline mode: no server bookkeeping)."""
        assert not self.server_mode
        self._grow_pairs(1)
        pid = self.n_pairs
        self._mu[pid] = mu0
        self._busy[pid] = 0.0
        self._cls[pid] = class_id
        self.n_pairs += 1
        return pid

    def open_pairs(self, class_ids: np.ndarray) -> int:
        """Bulk :meth:`open_pair`: one fresh standalone pair per entry of
        ``class_ids`` (offline mode), all free at ``mu0 = 0``.  Returns the
        first new pair id; the block is contiguous and id-ascending — the
        bulk primitive behind the offline deadline-prior pinning phase."""
        assert not self.server_mode
        k = int(np.shape(class_ids)[0])
        self._grow_pairs(k)
        base = self.n_pairs
        self._mu[base: base + k] = 0.0
        self._busy[base: base + k] = 0.0
        self._cls[base: base + k] = class_ids
        self.n_pairs += k
        return base

    def new_server(self, t: float, class_id: int = 0) -> int:
        """Build and power on a server of ``l`` fresh pairs; returns its id."""
        assert self.server_mode
        self._grow_servers(1)
        self._grow_pairs(self.l)
        sid = self.n_servers
        self._on[sid] = True
        self._on_since[sid] = t
        self._turn_ons[sid] = self.l
        self._srv_cls[sid] = class_id
        self._mu_srv[sid] = t
        lo = self.n_pairs
        self._mu[lo: lo + self.l] = t   # a fresh pair is free *now*
        self._busy[lo: lo + self.l] = 0.0
        self._cls[lo: lo + self.l] = class_id
        self.n_servers += 1
        self.n_pairs += self.l
        return sid

    def wake_server(self, sid: int, t: float):
        self._on[sid] = True
        self._on_since[sid] = t
        self._turn_ons[sid] += self.l
        self._mu[sid * self.l: (sid + 1) * self.l] = t
        self._mu_srv[sid] = t

    def acquire_pair(self, t: float, class_id: int = 0) -> int:
        """A fresh pair of ``class_id``: prefer re-powering an off server of
        that class over building a new one."""
        avail = ~self._on[: self.n_servers] \
            & (self._srv_cls[: self.n_servers] == class_id)
        if self._any_failed:
            avail &= ~self._srv_failed[: self.n_servers]
        off = np.flatnonzero(avail)
        if off.size:
            sid = int(off[0])
            self.wake_server(sid, t)
        else:
            sid = self.new_server(t, class_id)
        return sid * self.l

    def assign(self, pid: int, start: float, duration: float):
        end = start + duration
        self._mu[pid] = end
        self._busy[pid] += duration
        if self.server_mode:
            sid = pid // self.l
            if end > self._mu_srv[sid]:
                self._mu_srv[sid] = end

    def book_assignments(self, pids: np.ndarray, starts: np.ndarray,
                         durations: np.ndarray):
        """Busy-time and server-finish bookkeeping for a whole batch of
        assignments (duplicate pids allowed, in chronological order) whose
        pair ``mu`` column is written separately via :meth:`sync_mu` — the
        group-commit half of the vectorized placement path."""
        np.add.at(self._busy, pids, durations)
        if self.server_mode:
            np.maximum.at(self._mu_srv, pids // self.l, starts + durations)

    def sync_mu(self, pids: np.ndarray, mus: np.ndarray):
        """Write a block of pair finish times (the other group-commit half;
        values must be the result of chronologically applied assignments)."""
        self._mu[pids] = mus

    def settle(self, t: float = np.inf):
        """Advance the engine to time ``t``, booking every DRS power-off
        *event* that occurred on the way — exactly.

        A server's power-off event fires ``rho`` slots after its last pair
        frees up, i.e. at ``mu_srv + rho``.  Every ON server whose event
        time is ``<= t`` is powered off with an on-span of exactly
        ``mu_srv + rho - on_since`` — independent of how far past the event
        the simulation has advanced, so sparse arrival slots never inflate
        ``E_idle``.  ``settle()`` with no argument books all outstanding
        events (the online :meth:`finalize`).
        """
        ns = self.n_servers
        if not ns:
            return
        mu_srv = self._mu_srv[: ns]
        on = self._on[: ns]
        off = on & (mu_srv + self.rho <= t + _EPS)
        if off.any():
            self._on_time[: ns][off] += (mu_srv[off] + self.rho
                                         - self._on_since[: ns][off])
            self._on[: ns][off] = False
            if self.track_offs:
                self._off_log.extend(np.flatnonzero(off).tolist())

    def drain_offs(self) -> list:
        """Return (and clear) the server ids powered off since the last
        drain.  Only populated with ``track_offs`` set."""
        out = self._off_log
        self._off_log = []
        return out

    # Back-compat name: the sweep is now the exact event-settling primitive
    # (the old sweep booked ``t - on_since`` at whatever slot it happened to
    # run, overcharging E_idle by the full arrival gap past ``mu + rho``).
    drs_sweep = settle

    # -- fault transitions (repro_torch.core.faults) -------------------------------
    @property
    def pair_failed(self) -> np.ndarray:
        """Failed-pair mask, shape ``[n_pairs]``."""
        return self._pair_failed[: self.n_pairs]

    def fail_pairs(self, t: float, pids, busy_rollback=None) -> np.ndarray:
        """Crash the given pairs at time ``t``: energy settles EXACTLY at
        the failure instant — never past it.

        Callers must :meth:`settle` to ``t`` first, so every ON server has
        its power-off event strictly after ``t`` and the crash books the
        powered-on span ``t - on_since`` with no double counting.  Per
        failed pair the engine (a) truncates its finish time to ``t`` (an
        in-flight task dies at the crash), (b) subtracts ``busy_rollback``
        (the caller-computed booked-busy portion past ``t``; the
        :class:`repro_torch.core.faults.FaultInjector` derives it from the
        orphaned assignment records), and (c) marks the pair ineligible.
        A server whose pairs have ALL failed while powered on is a hard
        crash: its on-span is booked up to ``t`` (no ``rho`` power-off
        tail — the machine lost power, it did not drain) and it leaves the
        wake pool until :meth:`revive_pairs`.  Already-failed pairs are
        no-ops.  Returns the pair ids actually transitioned.
        """
        assert self.server_mode
        pids = np.asarray(pids, dtype=np.int64)
        if busy_rollback is not None:
            rb = np.asarray(busy_rollback, dtype=np.float64)
        fresh_m = ~self._pair_failed[pids]
        fresh = pids[fresh_m]
        if fresh.size == 0:
            return fresh
        self.pool_epoch += 1
        self._pair_failed[fresh] = True
        self._any_failed = True
        if busy_rollback is not None:
            np.subtract.at(self._busy, fresh, rb[fresh_m])
        self._mu[fresh] = np.minimum(self._mu[fresh], t)
        for sid in np.unique(fresh // self.l).tolist():
            lo = sid * self.l
            hi = lo + self.l
            # mu only ever moved *down* here: re-reduce this server's block.
            self._mu_srv[sid] = self._mu[lo:hi].max()
            self._srv_failed[sid] = True
            if self._on[sid] and self._pair_failed[lo:hi].all():
                self._on_time[sid] += t - self._on_since[sid]
                self._on[sid] = False
        return fresh

    def revive_pairs(self, t: float, pids) -> np.ndarray:
        """Repair the given pairs at time ``t`` (the inverse transition).

        A revived pair on a still-powered server becomes assignable from
        ``t`` (its ``mu`` is floored to ``t``); a revived pair on an OFF
        server costs nothing now — the server merely rejoins the wake pool
        (once none of its pairs is failed) and a later
        :meth:`acquire_pair` powers it on through the normal DRS event.
        Pairs that are not failed are no-ops.  Returns the pair ids
        actually transitioned.
        """
        assert self.server_mode
        pids = np.asarray(pids, dtype=np.int64)
        sel = pids[self._pair_failed[pids]]
        if sel.size == 0:
            return sel
        self.pool_epoch += 1
        self._pair_failed[sel] = False
        for sid in np.unique(sel // self.l).tolist():
            lo = sid * self.l
            hi = lo + self.l
            if not self._pair_failed[lo:hi].any():
                self._srv_failed[sid] = False
            if self._on[sid]:
                blk = sel[(sel >= lo) & (sel < hi)]
                self._mu[blk] = np.maximum(self._mu[blk], t)
                if self._mu_srv[sid] < t:
                    self._mu_srv[sid] = t
        self._any_failed = bool(self._pair_failed[: self.n_pairs].any())
        return sel

    # -- pair selection (the policy rules' vectorized primitives) ------------
    def on_pair_mask(self) -> np.ndarray:
        """Mask of pairs whose server is powered on, shape ``[n_pairs]``."""
        return np.repeat(self._on[: self.n_servers], self.l)

    def eligible_mask(self, class_id: Optional[int] = None):
        """Mask of assignable pairs (``None`` == all): every pair offline,
        only pairs of powered-on servers online, never a failed pair;
        restricted to one machine class when ``class_id`` is given."""
        mask = None
        if self.server_mode:
            mask = np.repeat(self._on[: self.n_servers], self.l)
            if self._any_failed:
                mask = mask & ~self._pair_failed[: self.n_pairs]
        if class_id is not None and len(self.classes) > 1:
            cmask = self._cls[: self.n_pairs] == class_id
            mask = cmask if mask is None else (mask & cmask)
        return mask

    def pool_ids(self, class_id: Optional[int] = None) -> np.ndarray:
        """Ascending ids of the currently assignable pairs — the compact-pool
        snapshot primitive of :mod:`repro_torch.core.placement`: every pair
        offline, pairs of powered-on servers online, optionally restricted
        to one machine class."""
        mask = self.eligible_mask(class_id)
        if mask is None:
            return np.arange(self.n_pairs, dtype=np.int64)
        return np.flatnonzero(mask)

    def worst_fit(self, class_id: Optional[int] = None) -> int:
        """The pair with the smallest mu (SPT; ties -> smallest id), or -1."""
        if self.n_pairs == 0:
            return -1
        mu = self.mu
        mask = self.eligible_mask(class_id)
        if mask is None:
            return int(np.argmin(mu))
        if not mask.any():
            return -1
        return int(np.argmin(np.where(mask, mu, np.inf)))

    def _fits(self, t_now: float, deadline: float, t_hat: float,
              class_id: Optional[int] = None):
        mu = self.mu
        fit = deadline - np.maximum(t_now, mu) >= t_hat - _EPS
        mask = self.eligible_mask(class_id)
        return fit if mask is None else (fit & mask)

    def best_fit(self, t_now: float, deadline: float, t_hat: float,
                 class_id: Optional[int] = None) -> int:
        """The *fitting* pair with the largest mu (tightest fit), or -1."""
        if self.n_pairs == 0:
            return -1
        fit = self._fits(t_now, deadline, t_hat, class_id)
        if not fit.any():
            return -1
        return int(np.argmax(np.where(fit, self.mu, -np.inf)))

    def first_fit(self, t_now: float, deadline: float, t_hat: float,
                  class_id: Optional[int] = None) -> int:
        """The lowest-id fitting pair, or -1."""
        if self.n_pairs == 0:
            return -1
        fit = self._fits(t_now, deadline, t_hat, class_id)
        if not fit.any():
            return -1
        return int(np.argmax(fit))

    # -- Eq. (7) finalizer ---------------------------------------------------
    def _energy(self):
        ns = self.n_servers
        srv_cls = self._srv_cls[:ns]
        pair_cls = self._cls[: self.n_pairs]
        e_idle = 0.0
        e_overhead = 0.0
        for k, mc in enumerate(self.classes):
            sm = srv_cls == k
            pm = pair_cls == k
            e_idle += mc.p_idle * (float(self._on_time[:ns][sm].sum()) * self.l
                                   - float(self.busy[pm].sum()))
            e_overhead += mc.delta_on * float(self._turn_ons[:ns][sm].sum())
        return e_idle, e_overhead

    def finalize(self):
        """Close the books: returns ``(e_idle, e_overhead, n_servers)``.

        Online mode settles every outstanding power-off event — the same
        :meth:`settle` primitive the simulation loop advances with, so a
        server powered off mid-run and one powered off here book the
        identical ``mu_srv + rho - on_since`` span; offline mode first runs
        Algorithm 3 per class to group the standalone pairs into
        (class-homogeneous) virtual servers, powered on for exactly their
        longest pair's span.  Both then evaluate the same Eq. (7)
        idle/overhead sums over the server arrays with per-class
        ``p_idle``/``delta_on``.
        """
        if self.server_mode:
            self.settle()
        elif self.n_pairs:
            # Algorithm 3 per class: each virtual server is powered on for
            # exactly its longest pair's span (servers never mix classes).
            pair_cls = self._cls[: self.n_pairs]
            spans, span_cls = [], []
            for k in range(len(self.classes)):
                mu_k = self.mu[pair_cls == k]
                if mu_k.size:
                    s = cl.server_spans(mu_k, self.l)
                    spans.append(s)
                    span_cls.append(np.full(s.shape[0], k, dtype=np.int64))
            spans = np.concatenate(spans) if spans else np.zeros(0)
            ns = spans.shape[0]
            self._grow_servers(ns)
            self._on_time[:ns] = spans
            self._turn_ons[:ns] = 0
            self._on[:ns] = False
            self._srv_cls[:ns] = np.concatenate(span_cls) if span_cls \
                else np.zeros(0, dtype=np.int64)
            self.n_servers = ns
        e_idle, e_overhead = self._energy()
        return e_idle, e_overhead, self.n_servers
