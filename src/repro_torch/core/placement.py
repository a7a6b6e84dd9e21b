"""The shared placement subsystem: pair selection over the ClusterEngine
columns for BOTH schedulers (paper §4.2 — the packing half of Algorithms
2, 5 and 6).

The offline batch packer (:func:`repro_torch.core.scheduling.schedule_offline`)
and the online arrival-group simulator
(:func:`repro_torch.core.online.schedule_online`) run the *same* placement rules:
order the tasks, try each task's machine classes min-energy-feasible first,
pick a pair of the class by the policy rule (worst fit / best fit / first
fit, with the EDL θ-readjustment shrinking a non-fitting task's window),
and fall back to a fresh pair of the task's primary class.  This module
owns that machinery once, parameterized by a :class:`PlacementContext`:

* **offline** is the degenerate "one group at ``t = 0``" case — the engine
  runs ``servers=False``, a fresh pair is a single standalone
  :meth:`~repro_torch.core.engine.ClusterEngine.open_pair`, and every pair is
  always eligible;
* **online** places one arrival group per call at its slot time — the
  engine runs ``servers=True``, a fresh pair is a DRS power-on of ``l``
  pairs (:meth:`~repro_torch.core.engine.ClusterEngine.acquire_pair`), and only
  pairs of powered-on servers are eligible.

Three placement paths per context, all bit-identical by construction:

* :meth:`PlacementContext.place_group_vector` — the batched worst-fit/SPT
  path (Algorithm 2/5 EDL and the plain worst-fit policy).  Worst-fit is a
  sequential min-extraction process, but it batches exactly under a
  frontier invariant: in task order, the group's class-``c`` tasks land on
  the smallest-``mu`` eligible pairs of class ``c`` *provided* each task
  fits (at its optimal length, or via a θ-readjustment window, whose pair
  ``mu`` is pinned to the task's deadline) and no already-assigned pair's
  new ``mu`` drops back to (or ties) the worst-fit frontier.  Both
  conditions are array ops over per-class *compact pools*
  (:class:`_GroupPools`) of the engine's ``mu``/``class_id`` columns; the
  batch rounds alternate with the scalar rule per collision, and a lazy
  frontier heap finishes the group when batching stops paying for itself.
* :meth:`PlacementContext.place_group_select` — the pooled first-fit
  (``"ff"``) / best-fit (``"bf"``) path (offline ``lpt-ff``/``edf-bf`` and
  the online Algorithm-6 first-fit), per-task probes vectorized over the
  class pools.
* :meth:`PlacementContext.place_group_scalar` — the per-task reference
  loop over the engine's own ``worst_fit``/``best_fit``/``first_fit``
  selectors; the bit-identity oracle the two paths above are pinned
  against (``tests/test_placement.py`` offline,
  ``tests/test_event_engine.py`` online).

The vectorized paths defer every engine write to one group commit
(:meth:`~repro_torch.core.engine.ClusterEngine.book_assignments` +
:meth:`~repro_torch.core.engine.ClusterEngine.sync_mu`) and gather the group's
assignment records from the config columns in one shot; only fresh-server
power-ons touch the engine live (they are DRS events).  θ-readjustment
rows are *not* solved here — a readjusted task occupies exactly its
window, so the rows are queued as :data:`PendingRow` and batch-priced
after packing (:func:`repro_torch.core.scheduling.fill_readjusted`).

See docs/ARCHITECTURE.md (placement subsystem layer) and docs/EQUATIONS.md
for the full equation/algorithm -> code map.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cluster as cl, machines
from repro_torch.core.engine import ClusterEngine
from repro_torch.core.single_task import TaskConfig

_EPS = 1e-9

# Persistent candidate streams are built/kept this many times deeper than
# the current group's ask: deep enough that consecutive groups rarely
# exhaust the carried frontier (a rebuild is an argpartition over the whole
# pool), shallow enough that the per-group touched-merge stays O(stream).
# Result-neutral: streams are a coverage window over the same (mu, pair id)
# order, and every consumer re-slices ``[:need]``.
_STREAM_OVERSHOOT = 8

#: pending θ-readjustment row: (assignment_index, task_index, window, class_id)
PendingRow = Tuple[int, int, float, int]

#: offline algorithm name -> pair-selection rule
OFFLINE_RULES = {"edl": "wf", "edf-wf": "wf", "edf-bf": "bf", "lpt-ff": "ff"}


def make_assignment(task: int, pair: int, start: float, cfg: TaskConfig,
                    duration: Optional[float] = None,
                    readjusted: bool = False, class_id: int = 0) -> cl.Assignment:
    """An assignment at the task's configured setting; a readjusted one gets
    its finish pinned to ``start + duration`` and its DVFS fields filled in
    later by :func:`repro_torch.core.scheduling.fill_readjusted`."""
    t = cfg.t_hat[task] if duration is None else duration
    return cl.Assignment(task=task, pair=pair, start=float(start),
                         finish=float(start + t), v=float(cfg.v[task]),
                         fc=float(cfg.fc[task]), fm=float(cfg.fm[task]),
                         power=float(cfg.p_hat[task]),
                         energy=float(cfg.e_hat[task]), readjusted=readjusted,
                         class_id=class_id)


def precompute(cfgs: Sequence[TaskConfig], order_cls: np.ndarray) -> dict:
    """Per-run lookups for the vectorized paths: config columns as numpy
    arrays (batch gathers) and as plain lists (the scalar-finish loop reads
    per-task floats ~20x faster off a list than off a numpy scalar)."""
    t_hat = [np.asarray(c.t_hat) for c in cfgs]
    t_min = [np.asarray(c.t_min) for c in cfgs]
    return {
        "t_hat": t_hat,
        "t_min": t_min,
        "t_hat_l": [a.tolist() for a in t_hat],
        "t_min_l": [a.tolist() for a in t_min],
        "order_cols": order_cls.T.tolist() if len(cfgs) > 1 else None,
        # record columns [v, fc, fm, p_hat, e_hat] stacked per class: one
        # fancy-index gathers a whole group's records
        "cols": [np.stack([np.asarray(c.v, np.float64),
                           np.asarray(c.fc, np.float64),
                           np.asarray(c.fm, np.float64),
                           np.asarray(c.p_hat, np.float64),
                           np.asarray(c.e_hat, np.float64)]) for c in cfgs],
    }


class _GroupPools:
    """Per-class compact pools for one placement call — or, in persistent
    mode, carried across every call of a run.

    A pool is the pair-id-ascending snapshot of the eligible pairs of one
    class, kept in sync for the rest of the call while the engine itself is
    only written at the group commit.  Its candidate stream is the
    ``(mu, pair id)``-sorted frontier computed once per call (stale entries
    drop out by exact ``mu`` comparison, a power-on appends its fresh
    pairs), and ``min_new`` tracks the smallest already-assigned finish
    time so a frontier re-entry is detected across batch rounds.

    **Persistent mode** (``PlacementContext(incremental=True)``, the
    pipelined online path): pools and candidate streams survive from one
    arrival group to the next under three delta rules instead of the
    per-group full rebuild —

    * *touched re-entry*: every pair whose ``mu`` moved (assignment, fresh
      power-on splice) is recorded by **pair id** (ids are stable under the
      position shifts that splices/deletions cause); at the next group
      the touched set is merged back into the stream at its current ``mu``.
      ``thresh`` records the stream's ``(mu, pair id)`` coverage bound from
      build time: every pool entry outside the stream compares strictly
      greater, assignments only *raise* ``mu``, so merged entries above the
      bound can be dropped and the stream stays the true global frontier.
    * *power-off deletion*: servers the engine's DRS settle powered off
      (``ClusterEngine.drain_offs``) have their contiguous pair block cut
      out of the pool; stream positions shift left.
    * *epoch invalidation*: any fault transition (``fail_pairs`` /
      ``revive_pairs`` bump ``ClusterEngine.pool_epoch``) mutates pairs
      behind the pool's back — eligibility masks, mu truncations, orphan
      re-placements — so everything is dropped and lazily rebuilt from the
      live engine.  Failures are rare events; correctness over cleverness.
    """

    __slots__ = ("ctx", "eng", "t_now", "grain", "t_hat_l", "pools", "cands",
                 "fresh", "min_new", "pid_col", "start_col", "dur_col",
                 "cls_col", "persistent", "touched", "thresh", "needs_merge",
                 "epoch")

    def __init__(self, ctx: "PlacementContext", t_now: float,
                 pid_col: np.ndarray, start_col: np.ndarray,
                 dur_col: np.ndarray, cls_col: np.ndarray):
        self.ctx = ctx
        self.eng = ctx.eng
        self.t_now = t_now
        self.grain = ctx.grain
        self.t_hat_l = ctx.pre["t_hat_l"]
        self.pools: Dict[int, list] = {}
        self.cands: Dict[int, list] = {}
        self.fresh: Dict[int, list] = {}
        self.min_new: Dict[int, float] = {}
        self.pid_col = pid_col
        self.start_col = start_col
        self.dur_col = dur_col
        self.cls_col = cls_col
        self.persistent = False
        self.touched: Dict[int, list] = {}
        self.thresh: Dict[int, Optional[tuple]] = {}
        self.needs_merge: set = set()
        self.epoch = 0

    def begin_group(self, t_now: float, pid_col: np.ndarray,
                    start_col: np.ndarray, dur_col: np.ndarray,
                    cls_col: np.ndarray):
        """Rebind the per-group output columns and reconcile the carried
        pool state with everything the engine did since the last group."""
        self.t_now = t_now
        self.pid_col = pid_col
        self.start_col = start_col
        self.dur_col = dur_col
        self.cls_col = cls_col
        eng = self.eng
        if eng.pool_epoch != self.epoch:
            self.epoch = eng.pool_epoch
            self.pools.clear()
            self.cands.clear()
            self.fresh.clear()
            self.min_new.clear()
            self.touched.clear()
            self.thresh.clear()
            self.needs_merge.clear()
            eng.drain_offs()
            return
        # Unconsumed fresh splices may sit below any stream bound: convert
        # them (by id) into touched entries for the merge.  Must happen
        # BEFORE power-off deletions shift pool positions.
        for c, fl in self.fresh.items():
            if fl:
                ids = self.pools[c][0]
                self.touched.setdefault(c, []).append(
                    ids[np.asarray(fl, dtype=np.int64)])
                self.fresh[c] = []
        offs = eng.drain_offs()
        if offs:
            self.apply_offs(offs)
        for c in self.min_new:
            self.min_new[c] = np.inf
        self.needs_merge = set(self.cands)
        for c in self.touched:
            if c not in self.cands:
                # No stream to reconcile against; a later build is full.
                self.touched[c] = []

    def apply_offs(self, sids):
        """Cut the powered-off servers' contiguous pair blocks out of their
        class pools (and shift/drop stream positions accordingly).  A
        powered-on server always has its whole ``grain`` block in the pool,
        so the whole batch is one keep-mask compaction per class — a
        per-``sid`` slice shift is O(offs * pool) and collapses on diurnal
        traces, where a falling edge powers off thousands of servers at
        once.  Order-preserving, so it commutes with the loop form."""
        grain = self.grain
        eng = self.eng
        multi = len(eng.classes) > 1
        if multi:
            by_class: Dict[int, list] = {}
            for sid in sids:
                by_class.setdefault(eng.server_class(sid), []).append(sid)
        else:
            by_class = {0: list(sids)}
        for c, csids in by_class.items():
            st = self.pools.get(c)
            if st is None:
                continue
            ids, mus, n = st
            live = ids[:n]
            lo_id = np.asarray(sorted(csids), dtype=np.int64) * grain
            lo = np.searchsorted(live, lo_id)
            hi = np.searchsorted(live, lo_id + grain)
            if not np.any(hi > lo):
                continue
            # Deleted-coverage mask over positions via a range-diff sweep.
            diff = np.zeros(n + 1, dtype=np.int64)
            np.add.at(diff, lo, 1)
            np.add.at(diff, hi, -1)
            dead = np.cumsum(diff[:n]) > 0
            keep = ~dead
            m = int(keep.sum())
            if m == n:
                continue
            shift = np.cumsum(dead) - dead    # deleted positions before p
            ids[:m] = live[keep]
            mus[:m] = mus[:n][keep]
            st[2] = m
            cst = self.cands.get(c)
            if cst is not None:
                cp, cm = cst
                km = keep[cp]
                if not km.all():
                    cp, cm = cp[km], cm[km]
                self.cands[c] = [cp - shift[cp], cm]

    def _merge_carry(self, c: int):
        """Fold the touched pair ids back into class ``c``'s carried stream
        at their current ``mu`` (dropping entries beyond the coverage
        bound and pairs that left the pool), keeping ``(mu, pair id)``
        order — position order == id order inside a pool."""
        ids, mus, n = self.pools[c]
        cp, cm = self.cands[c]
        alive = mus[cp] == cm
        if not alive.all():
            cp, cm = cp[alive], cm[alive]
        tl = self.touched.get(c)
        if tl:
            tids = np.unique(np.concatenate(
                [np.atleast_1d(np.asarray(x, dtype=np.int64)) for x in tl]))
            self.touched[c] = []
            pos = np.searchsorted(ids[:n], tids)
            ok = pos < n
            pos = np.where(ok, pos, 0)
            ok &= ids[pos] == tids
            pos = pos[ok]
            if pos.size:
                tmu = mus[pos]
                th = self.thresh.get(c)
                if th is not None:
                    t_mu, t_pid = th
                    keep = (tmu < t_mu) | ((tmu == t_mu)
                                           & (ids[pos] <= t_pid))
                    pos, tmu = pos[keep], tmu[keep]
                if pos.size:
                    allp = np.concatenate([cp, pos])
                    allm = np.concatenate([cm, tmu])
                    o = np.lexsort((allp, allm))
                    cp, cm = allp[o], allm[o]
        st = self.cands[c] = [cp, cm]
        return st

    def pool(self, c: int):
        """Compact (pair-id ascending) snapshot of the eligible pairs of
        class c as ``[ids, mus, n]`` (capacity-grown append arrays).  Built
        lazily; pairs acquired later in the call are spliced in by
        :meth:`acquire`, which always creates the pool first — so the lazy
        snapshot can never miss a same-class pair."""
        st = self.pools.get(c)
        if st is None:
            ids = self.eng.pool_ids(c)
            st = self.pools[c] = [ids,
                                  self.eng.mu[ids].astype(np.float64,
                                                          copy=True),
                                  ids.size]
            self.min_new[c] = np.inf
        return st

    def candidates(self, c: int, need: int):
        """Up to ``need`` live frontier entries of class c as (positions,
        recorded mus), ordered by ``(mu, pair id)``."""
        ids, mus, n = self.pool(c)
        st = self.cands.get(c)
        clean = False   # stream (re)built/merged this call -> fully alive
        if st is not None and c in self.needs_merge:
            self.needs_merge.discard(c)
            st = self._merge_carry(c)
            clean = True
            if st[0].size < need and self.thresh.get(c) is not None:
                # Carried stream exhausted below the ask while entries past
                # its coverage bound exist: refresh with a full build.
                st = None
                del self.cands[c]
            elif st[0].size > max(_STREAM_OVERSHOOT * need, 64):
                # Keep the carried stream bounded: drop the sorted tail and
                # *tighten* the coverage bound to the last kept entry (the
                # dropped entries all compare greater, and any future mu
                # move re-enters through the touched set) — without this a
                # full-coverage stream (thresh None) re-absorbs every
                # touched pair forever and the per-group merge degenerates
                # into maintaining a whole sorted pool.
                keep = max(_STREAM_OVERSHOOT * need, 64)
                cp, cm = st[0][:keep], st[1][:keep]
                self.thresh[c] = (float(cm[-1]), int(ids[cp[-1]]))
                st = self.cands[c] = [cp, cm]
        if st is None:
            # Persistent mode overshoots the ask: a stream of exactly
            # ``need`` entries is fully consumed by its own group, which
            # would force a rebuild every group and make the carry pure
            # overhead.  The extra entries are the same frontier, just
            # deeper — the return below still slices [:need].
            kc = min(max(_STREAM_OVERSHOOT * need, 64)
                     if self.persistent else need, n)
            m_live = mus[:n]
            if kc and kc < n:
                part = np.argpartition(m_live, kc - 1)[:kc]
                cp = np.flatnonzero(m_live <= m_live[part].max())
                cp = cp[np.lexsort((cp, m_live[cp]))][:kc]
            else:
                cp = np.argsort(m_live, kind="stable")
            st = self.cands[c] = [cp, m_live[cp].copy()]
            clean = True
            if self.persistent:
                self.thresh[c] = None if cp.size >= n else \
                    (float(st[1][-1]), int(ids[cp[-1]]))
                self.touched[c] = []
                self.fresh.pop(c, None)
        cp, cm = st
        if not clean:
            alive = self.pools[c][1][cp] == cm    # assigned entries drop out
            if not alive.all():
                cp, cm = cp[alive], cm[alive]
                self.cands[c] = [cp, cm]
        fr = self.fresh.get(c)
        if fr:
            fa = np.sort(np.asarray(fr, dtype=np.int64))
            fa = fa[self.pools[c][1][fa] == self.t_now]  # consumed drop out
            if fa.size:
                allp = np.concatenate([cp, fa])
                allm = np.concatenate([cm, np.full(fa.size, self.t_now)])
                o = np.lexsort((allp, allm))      # position order == id order
                return allp[o][:need], allm[o][:need]
        return cp[:need], cm[:need]

    def acquire(self, i: int, g: int, c: int):
        """Fresh-pair fallback: open a fresh pair of class ``c`` (offline a
        standalone pair, online a DRS power-on of ``grain = l`` pairs — a
        live engine event), splice the new pairs into the class pool, and
        assign the first one to task ``g`` at position ``i``."""
        t_now = self.t_now
        grain = self.grain
        eng = self.eng
        # Snapshot the pool BEFORE firing the engine event: pool_ids reads
        # live engine state, so a pool built after the power-on would
        # already contain the fresh pairs the splice below adds.
        st = self.pools.get(c)
        if st is None:
            st = self.pool(c)
        pid = eng.acquire_pair(t_now, class_id=c) if eng.server_mode \
            else eng.open_pair(class_id=c)
        ids, mus, n = st
        if n == 0 or pid > ids[n - 1]:            # append (always offline)
            pos = n
            if n + grain > ids.shape[0]:          # grow capacity, amortized
                grow = max(n + grain, 2 * ids.shape[0])
                st[0] = ids = np.concatenate(
                    [ids, np.empty(grow - ids.shape[0], dtype=np.int64)])
                st[1] = mus = np.concatenate(
                    [mus, np.empty(grow - mus.shape[0])])
        else:
            # waking a lower-id server inserts mid-pool: shift the stored
            # candidate/fresh positions past the insertion point.
            pos = int(np.searchsorted(ids[:n], pid))
            st[0] = ids = np.insert(ids[:n], pos,
                                    np.zeros(grain, dtype=np.int64))
            st[1] = mus = np.insert(mus[:n], pos, np.zeros(grain))
            if c in self.cands:
                cp, cm = self.cands[c]
                self.cands[c] = [np.where(cp >= pos, cp + grain, cp), cm]
            if self.fresh.get(c):
                self.fresh[c] = [p + grain if p >= pos else p
                                 for p in self.fresh[c]]
        th = self.t_hat_l[c][g]
        if grain == 1:                            # offline: one standalone pair
            ids[pos] = pid
        else:
            ids[pos: pos + grain] = pid + np.arange(grain)
            mus[pos + 1: pos + grain] = t_now
            self.fresh.setdefault(c, []).extend(range(pos + 1, pos + grain))
        st[2] = n + grain
        mus[pos] = t_now + th                     # a fresh pair is free *now*
        if self.persistent:
            self.touched.setdefault(c, []).append(pid)
        if self.min_new[c] > t_now + th:
            self.min_new[c] = t_now + th
        self.pid_col[i] = pid
        self.start_col[i] = t_now
        self.dur_col[i] = th
        self.cls_col[i] = c
        return pos, pos != n


class PlacementContext:
    """One scheduler run's placement state: the engine handle, the per-class
    Algorithm-1 configs and their precomputed column lookups, the policy
    knobs (θ, readjustment on/off) and the output sinks (the assignment
    list and the pending θ-readjustment rows).

    ``readjust`` enables the EDL θ-readjustment on the worst-fit rule; it
    only takes effect for ``theta < 1`` (at ``θ = 1`` the readjustment
    window ``max(θ·t_hat, t_min)`` equals ``t_hat`` and can never admit a
    task the plain fit test rejected).  The fresh-pair granularity follows
    the engine mode: a standalone pair offline, a server of ``l`` pairs
    online.
    """

    def __init__(self, eng: ClusterEngine, cfgs: Sequence[TaskConfig],
                 deadline: np.ndarray, *, theta: float = 1.0,
                 readjust: bool = False,
                 assignments: Optional[List[cl.Assignment]] = None,
                 pending: Optional[List[PendingRow]] = None,
                 order_cls: Optional[np.ndarray] = None,
                 incremental: bool = False):
        self.eng = eng
        self.cfgs = list(cfgs)
        self.deadline = np.asarray(deadline, dtype=np.float64)
        self.theta = float(theta)
        self.readjust = bool(readjust) and self.theta < 1.0
        self.assignments = assignments if assignments is not None else []
        self.pending = pending if pending is not None else []
        self.order_cls = order_cls if order_cls is not None \
            else machines.class_order(self.cfgs)
        self.primary = self.order_cls[0]
        self.grain = eng.l if eng.server_mode else 1
        self._pre = None
        # Incremental mode (the pipelined online scheduler): pools and
        # candidate streams persist across groups with delta reconciliation
        # instead of a per-group rebuild; the engine logs power-offs for the
        # deletion deltas.
        self.incremental = bool(incremental)
        self._gp: Optional[_GroupPools] = None
        if self.incremental:
            eng.track_offs = True

    @property
    def pre(self) -> dict:
        """The :func:`precompute` column lookups, built on first use (the
        scalar reference path never touches them)."""
        if self._pre is None:
            self._pre = precompute(self.cfgs, self.order_cls)
        return self._pre

    def update_tasks(self, idx):
        """Refresh the :attr:`pre` lookups for the tasks in ``idx`` (an
        index array, or a contiguous ``slice`` — what the pipelined driver
        passes for slot-sorted traces) after their config columns were
        filled in place (the pipelined config prefetch consumes Algorithm-1
        solutions chunk by chunk).  The numpy entries of ``pre`` alias the
        config arrays, so only the derived list mirrors and the stacked
        record columns need resyncing — all mutated in place so aliases
        held by a persistent pool stay live."""
        if self._pre is None:
            # First chunk: the plain build snapshots current (chunk-filled)
            # values; unfilled tasks hold garbage until their own refresh.
            self._pre = precompute(self.cfgs, self.order_cls)
            return
        pre = self._pre
        for c, cfg in enumerate(self.cfgs):
            pre["cols"][c][:, idx] = np.stack(
                [np.asarray(cfg.v, np.float64)[idx],
                 np.asarray(cfg.fc, np.float64)[idx],
                 np.asarray(cfg.fm, np.float64)[idx],
                 np.asarray(cfg.p_hat, np.float64)[idx],
                 np.asarray(cfg.e_hat, np.float64)[idx]])
            th = np.asarray(cfg.t_hat)[idx].tolist()
            tm = np.asarray(cfg.t_min)[idx].tolist()
            th_l = pre["t_hat_l"][c]
            tm_l = pre["t_min_l"][c]
            if isinstance(idx, slice):
                th_l[idx] = th
                tm_l[idx] = tm
            else:
                for j, i in enumerate(idx.tolist()):
                    th_l[i] = th[j]
                    tm_l[i] = tm[j]
        if pre["order_cols"] is not None:
            oc = self.order_cls[:, idx].T.tolist()
            order_cols = pre["order_cols"]
            if isinstance(idx, slice):
                order_cols[idx] = oc
            else:
                for j, i in enumerate(idx.tolist()):
                    order_cols[i] = oc[j]

    def _group_pools(self, t_now: float, pid_col: np.ndarray,
                     start_col: np.ndarray, dur_col: np.ndarray,
                     cls_col: np.ndarray) -> _GroupPools:
        """The per-call pool state: a throwaway instance normally, the
        carried one (delta-reconciled) in incremental mode."""
        if not self.incremental:
            return _GroupPools(self, t_now, pid_col, start_col, dur_col,
                               cls_col)
        gp = self._gp
        if gp is None:
            gp = self._gp = _GroupPools(self, t_now, pid_col, start_col,
                                        dur_col, cls_col)
            gp.persistent = True
            gp.epoch = self.eng.pool_epoch
            self.eng.drain_offs()   # nothing existed to reconcile yet
        else:
            gp.begin_group(t_now, pid_col, start_col, dur_col, cls_col)
        return gp

    def acquire_fresh(self, t_now: float, class_id: int) -> int:
        """A fresh pair of ``class_id`` through the engine-mode-appropriate
        primitive: offline a standalone pair, online a DRS power-on."""
        if self.eng.server_mode:
            return self.eng.acquire_pair(t_now, class_id=class_id)
        return self.eng.open_pair(class_id=class_id)

    # -- group commit --------------------------------------------------------

    def _commit_group(self, gidx: np.ndarray, pid_col: np.ndarray,
                      start_col: np.ndarray, dur_col: np.ndarray,
                      readj_col: np.ndarray, cls_col: np.ndarray):
        """Commit one placed group to the engine in one shot (power-ons
        already wrote their pairs live; only assigned pairs moved, and for
        a pair assigned twice the chronologically last finish wins), then
        gather the group's assignment records."""
        k = gidx.shape[0]
        self.eng.book_assignments(pid_col, start_col, dur_col)
        _, last = np.unique(pid_col[::-1], return_index=True)
        last = k - 1 - last
        self.eng.sync_mu(pid_col[last], start_col[last] + dur_col[last])
        self._gather(gidx, pid_col, start_col, dur_col, readj_col, cls_col)

    def _gather(self, gidx: np.ndarray, pid_col: np.ndarray,
                start_col: np.ndarray, dur_col: np.ndarray,
                readj_col: np.ndarray, cls_col: np.ndarray):
        """Bulk-build the group's assignment records from the config
        columns (one fancy-index per class present)."""
        pre = self.pre
        k = gidx.shape[0]
        if len(self.cfgs) == 1:
            mat = pre["cols"][0][:, gidx]
        else:
            mat = np.empty((5, k))
            for c in np.unique(cls_col):
                m = cls_col == c
                mat[:, m] = pre["cols"][int(c)][:, gidx[m]]
        v_l, fc_l, fm_l, p_l, e_l = mat.tolist()
        finish = start_col + dur_col
        self.assignments.extend(map(
            cl.Assignment, gidx.tolist(), pid_col.tolist(),
            start_col.tolist(), finish.tolist(), v_l, fc_l, fm_l, p_l, e_l,
            readj_col.tolist(), cls_col.tolist()))

    # -- placement paths -----------------------------------------------------

    def pin_fresh(self, tids: np.ndarray):
        """Each task on its OWN fresh pair of its primary class at ``t = 0``
        (the offline deadline-prior phase: these tasks must start
        immediately), opened and committed in bulk."""
        tids = np.asarray(tids, dtype=np.int64)
        k = tids.shape[0]
        if k == 0:
            return
        cls = self.primary[tids].astype(np.int64, copy=True)
        t_hat = np.empty(k)
        for c in np.unique(cls):
            m = cls == c
            t_hat[m] = self.pre["t_hat"][int(c)][tids[m]]
        base = self.eng.open_pairs(cls)
        pids = base + np.arange(k, dtype=np.int64)
        starts = np.zeros(k)
        self.eng.book_assignments(pids, starts, t_hat)
        self.eng.sync_mu(pids, t_hat)
        self._gather(tids, pids, starts, t_hat, np.zeros(k, dtype=bool), cls)

    def prepare_chunk(self, groups):
        """Hoist the per-group prologue of :meth:`place_group_vector` for a
        run of arrival groups (the pipelined driver's chunk): ONE stable
        lexsort replaces each group's stable deadline argsort (equal
        permutations — the group id is the primary key and lexsort keeps
        arrival order on deadline ties, exactly like the per-group
        ``kind="stable"`` argsort), and the task-column gathers vectorize
        across the whole chunk.  Returns one ``(gidx, prim, d, t_hat)``
        tuple per group, each bit-identical to the inline prologue."""
        sizes = [idx.shape[0] for _, idx in groups]
        cat = np.concatenate([idx for _, idx in groups])
        gid = np.repeat(np.arange(len(sizes)), sizes)
        d_cat = self.deadline[cat]
        order = np.lexsort((d_cat, gid))
        gidx = cat[order]
        d_s = d_cat[order]
        prim = self.primary[gidx]
        pre = self.pre
        if len(self.cfgs) == 1:
            t_hat = pre["t_hat"][0][gidx]
        else:
            t_hat = np.empty(gidx.shape[0])
            for c in np.unique(prim):
                m = prim == c
                t_hat[m] = pre["t_hat"][int(c)][gidx[m]]
        out = []
        off = 0
        for s in sizes:
            sl = slice(off, off + s)
            out.append((gidx[sl], prim[sl], d_s[sl], t_hat[sl]))
            off += s
        return out

    def place_group_vector(self, idx, order, t_now: float, prep=None):
        """Batched worst-fit/SPT (+ θ-readjustment) placement for one
        ordered group — Algorithm 2/5's pair rule.

        The placement loop alternates: batch the longest provable prefix
        (see the frontier invariant in the module docstring), then place
        the single violating task through the scalar rule — class fallback,
        readjustment that does not batch, fresh-pair power-on, an exact
        ``mu`` tie — and resume batching while a round nets enough tasks to
        pay for itself; otherwise (power-on ramp, saturated frontier) the
        rest of the group runs the same scalar rule as a tight loop over
        the pools with a lazy frontier heap.  Bit-identical to
        :meth:`place_group_scalar` (rule ``"wf"``) by construction.

        ``prep`` injects the group's :meth:`prepare_chunk` tuple; ``idx``
        and ``order`` are ignored then (the tuple already IS the ordered
        group).
        """
        if prep is not None:
            gidx, prim, d, t_hat = prep
            k = gidx.shape[0]
            if k == 0:
                return
            pre = self.pre
        else:
            k = order.shape[0]
            if k == 0:
                return
            pre = self.pre
            gidx = np.asarray(idx)[order]         # [k] task ids, batch order
            prim = self.primary[gidx]             # [k] primary class per task
            d = self.deadline[gidx]
        theta = self.theta
        readjust_on = self.readjust
        pending = self.pending
        t_hat_cls = pre["t_hat"]
        t_min_cls = pre["t_min"]
        t_hat_l = pre["t_hat_l"]
        t_min_l = pre["t_min_l"]
        order_cols = pre["order_cols"]
        grain = self.grain

        # Per-group record columns, filled by the batch rounds and the
        # scalar violators; records and engine state are committed once at
        # the end.
        if prep is None:
            t_hat = np.empty(k)
            for c in np.unique(prim):
                m = prim == c
                t_hat[m] = t_hat_cls[int(c)][gidx[m]]
        pid_col = np.empty(k, dtype=np.int64)
        start_col = np.empty(k)
        dur_col = t_hat.copy()
        cls_col = prim.astype(np.int64, copy=True)
        readj_col = np.zeros(k, dtype=bool)
        base = len(self.assignments)

        gp = self._group_pools(t_now, pid_col, start_col, dur_col, cls_col)
        pool = gp.pool
        candidates = gp.candidates
        pools = gp.pools
        fresh = gp.fresh
        min_new = gp.min_new
        persistent = gp.persistent
        touched = gp.touched

        valid = np.empty(k, dtype=bool)
        pos_sel = np.empty(k, dtype=np.int64)

        def batch_round(pos0: int) -> int:
            """Batch the longest provable prefix of tasks[pos0:]; returns
            the number of positions consumed."""
            valid[pos0:] = False
            if order_cols is None:                # single class: no split
                by_class = ((0, np.arange(pos0, k)),)
            else:
                sub = prim[pos0:]
                by_class = tuple((int(c), pos0 + np.flatnonzero(sub == c))
                                 for c in np.unique(sub))
            for c, tm in by_class:
                cp, cm = candidates(int(c), tm.size)
                kc = cp.size
                if not kc:
                    continue
                w = t_hat[tm[:kc]]
                start = np.maximum(t_now, cm)
                window = d[tm[:kc]] - start
                fit = window >= w - _EPS          # fits at optimal length
                if readjust_on:
                    # The θ-readjustment batches under the same frontier
                    # check: the task occupies exactly its window, so its
                    # pair's new mu is pinned to the task's deadline.
                    t_min_c = t_min_cls[int(c)][gidx[tm[:kc]]]
                    readj = ~fit & (window >= np.maximum(theta * w, t_min_c)
                                    - _EPS)
                else:
                    readj = np.zeros(kc, dtype=bool)
                dur = np.where(fit, w, window)
                ok = fit | readj
                # no-collision: every already-assigned pair's new mu
                # (previous rounds and this one) stays strictly above the
                # next candidate (ties -> scalar fallback).
                pm = np.minimum.accumulate(start + dur)
                ok &= np.concatenate(([min_new[int(c)]],
                                      np.minimum(pm[:-1],
                                                 min_new[int(c)]))) > cm
                nvalid = kc if ok.all() else int(np.argmin(ok))
                if nvalid:
                    sel = tm[:nvalid]
                    valid[sel] = True
                    pos_sel[sel] = cp[:nvalid]
                    start_col[sel] = start[:nvalid]
                    dur_col[sel] = dur[:nvalid]
                    readj_col[sel] = readj[:nvalid]
            cut = k if valid[pos0:].all() \
                else pos0 + int(np.argmin(valid[pos0:]))
            if cut == pos0:
                return 0
            if order_cols is None:
                by_class = ((0, np.arange(pos0, cut)),)
            else:
                sub = prim[pos0:cut]
                by_class = tuple((int(c), pos0 + np.flatnonzero(sub == c))
                                 for c in np.unique(sub))
            for c, m in by_class:
                ids, mus, _ = pools[int(c)]
                pos = pos_sel[m]
                new_mu = start_col[m] + dur_col[m]
                mus[pos] = new_mu
                pid_col[m] = ids[pos]
                if persistent:
                    touched.setdefault(int(c), []).append(pid_col[m].copy())
                min_new[int(c)] = min(min_new[int(c)], float(new_mu.min()))
            for i in np.flatnonzero(readj_col[pos0:cut]).tolist():
                i += pos0
                pending.append((base + i, int(gidx[i]), float(dur_col[i]),
                                int(prim[i])))
            return cut - pos0

        def place_one(i: int):
            """The scalar rule for one violating task, over the same pools
            (argmin over a pool's contiguous mu column is worst-fit with
            the identical lowest-pair-id tie-break)."""
            g = int(gidx[i])
            dd = d[i]
            readj_col[i] = False  # may hold a stale beyond-cut batch verdict
            for c in (order_cols[g] if order_cols is not None else (0,)):
                ids, mus, n = pool(c)
                if not n:
                    continue
                j = int(mus[:n].argmin())
                mu_j = mus[j]
                start = t_now if mu_j < t_now else float(mu_j)
                th = t_hat_l[c][g]
                if dd - start >= th - _EPS:
                    mus[j] = start + th
                    if persistent:
                        touched.setdefault(c, []).append(int(ids[j]))
                    if min_new[c] > start + th:
                        min_new[c] = start + th
                    pid_col[i], start_col[i], dur_col[i], cls_col[i] = \
                        ids[j], start, th, c
                    return
                elif readjust_on:
                    t_theta = theta * th
                    t_mn = t_min_l[c][g]
                    if t_theta < t_mn:
                        t_theta = t_mn
                    window = dd - start
                    if window >= t_theta - _EPS:
                        mus[j] = start + window
                        if persistent:
                            touched.setdefault(c, []).append(int(ids[j]))
                        if min_new[c] > start + window:
                            min_new[c] = start + window
                        pending.append((base + i, g, window, c))
                        pid_col[i], start_col[i], dur_col[i], cls_col[i] = \
                            ids[j], start, window, c
                        readj_col[i] = True
                        return
            gp.acquire(i, g, int(prim[i]))

        def finish_scalar(i0: int):
            """The scalar rule for the rest of the group as a tight loop
            over a lazy frontier heap: alive candidate-stream originals,
            pairs already assigned this group, and outstanding fresh pairs,
            keyed ``(mu, pair id)`` — exactly argmin's lowest-pair-id
            tie-break.  Entries go stale by exact ``mu`` comparison; when
            the original stream runs dry while uncovered pool entries
            exist, the loop degrades to plain argmin over the pool.
            Per-task reads come off plain python lists and the record
            columns are written back in bulk.  Multi-class groups fall back
            to the per-task rule, which also handles class fallback."""
            if order_cols is not None:
                for j in range(i0, k):
                    place_one(j)
                return
            gl = gidx.tolist()
            dl = d.tolist()
            th_l = t_hat_l[0]
            tm_l = t_min_l[0]
            pid_l, st_l, du_l, rj_l = [], [], [], []
            ids, mus, n = pool(0)
            cp, cm = candidates(0, k - i0)
            heap = [(m, int(ids[p]), int(p), True)
                    for m, p in zip(cm.tolist(), cp.tolist())]
            alive_orig = len(heap)
            statics = alive_orig < n              # uncovered pool entries?
            if i0:
                tpos = np.unique(np.searchsorted(ids[:n], pid_col[:i0]))
                heap += [(float(mus[p]), int(ids[p]), int(p), False)
                         for p in tpos.tolist()]
            for p in fresh.get(0, ()):
                if mus[p] == t_now:
                    heap.append((t_now, int(ids[p]), int(p), False))
            heapq.heapify(heap)
            heap_ok = True
            for j in range(i0, k):
                g = gl[j]
                dd = dl[j]
                top = None
                if heap_ok:
                    while heap:
                        e = heap[0]
                        if mus[e[2]] == e[0]:
                            top = e
                            break
                        heapq.heappop(heap)
                        if e[3]:
                            alive_orig -= 1
                    if top is None or (statics and alive_orig == 0):
                        heap_ok = False
                        top = None
                if not heap_ok and n:
                    p = int(mus[:n].argmin())
                    top = (float(mus[p]), int(ids[p]), p, False)
                if top is not None:
                    mu_p, pid, p = top[0], top[1], top[2]
                    start = t_now if mu_p < t_now else mu_p
                    th = th_l[g]
                    if dd - start >= th - _EPS:
                        if heap_ok:
                            heapq.heappop(heap)
                            if top[3]:
                                alive_orig -= 1
                            heapq.heappush(heap, (start + th, pid, p, False))
                        mus[p] = start + th
                        pid_l.append(pid)
                        st_l.append(start)
                        du_l.append(th)
                        rj_l.append(False)
                        continue
                    if readjust_on:
                        t_theta = theta * th
                        t_mn = tm_l[g]
                        if t_theta < t_mn:
                            t_theta = t_mn
                        window = dd - start
                        if window >= t_theta - _EPS:
                            if heap_ok:
                                heapq.heappop(heap)
                                if top[3]:
                                    alive_orig -= 1
                                heapq.heappush(heap,
                                               (start + window, pid, p,
                                                False))
                            mus[p] = start + window
                            pending.append((base + j, g, window, 0))
                            pid_l.append(pid)
                            st_l.append(start)
                            du_l.append(window)
                            rj_l.append(True)
                            continue
                pos, mid = gp.acquire(j, g, 0)
                ids, mus, n = pools[0]
                if heap_ok:
                    if mid:
                        # positions past the insertion point shifted
                        heap = [(m_, pi_, p_ + grain if p_ >= pos else p_,
                                 o_) for m_, pi_, p_, o_ in heap]
                    npid = int(ids[pos])
                    heapq.heappush(heap, (float(mus[pos]), npid, pos, False))
                    for jj in range(1, grain):
                        heapq.heappush(heap,
                                       (t_now, npid + jj, pos + jj, False))
                pid_l.append(pid_col[j])
                st_l.append(t_now)
                du_l.append(dur_col[j])
                rj_l.append(False)
            pid_col[i0:] = pid_l
            start_col[i0:] = st_l
            dur_col[i0:] = du_l
            readj_col[i0:] = rj_l
            if persistent and pid_l:
                touched.setdefault(0, []).append(
                    np.asarray(pid_l, dtype=np.int64))

        def finish_offline(i0: int):
            """The offline (single-class, ``grain == 1``) specialization of
            :func:`finish_scalar`: the scalar worst-fit rule as a frontier
            heap over plain python floats.

            With no power-on granule and no eligibility churn the WHOLE
            pool fits in the heap (so no lazy-staleness or argmin-degrade
            machinery is needed — a ``(mu, pair id)`` heap top IS argmin's
            lowest-pair-id tie-break, and every mutation is a
            ``heapreplace`` of the top), and fresh pairs are deferred to
            ONE bulk :meth:`~repro_torch.core.engine.ClusterEngine.open_pairs` —
            offline pair ids are sequential, so they are known without
            touching the engine inside the loop.  Bit-identical to the
            scalar rule by construction: the list mirrors hold the exact
            float64 values of the pool columns."""
            eng = self.eng
            ids_a, mus_a, n = pool(0)
            gl = gidx.tolist()
            dl = d.tolist()
            th_l = t_hat_l[0]
            tm_l = t_min_l[0]
            pid_l, st_l, du_l, rj_l = [], [], [], []
            heap = list(zip(mus_a[:n].tolist(), ids_a[:n].tolist()))
            heapq.heapify(heap)
            heappush = heapq.heappush
            heapreplace = heapq.heapreplace
            pid_next = eng.n_pairs
            n_fresh = 0
            for j in range(i0, k):
                g = gl[j]
                dd = dl[j]
                if heap:
                    mu_p, pid = heap[0]
                    start = t_now if mu_p < t_now else mu_p
                    th = th_l[g]
                    if dd - start >= th - _EPS:
                        heapreplace(heap, (start + th, pid))
                        pid_l.append(pid)
                        st_l.append(start)
                        du_l.append(th)
                        rj_l.append(False)
                        continue
                    if readjust_on:
                        t_theta = theta * th
                        t_mn = tm_l[g]
                        if t_theta < t_mn:
                            t_theta = t_mn
                        window = dd - start
                        if window >= t_theta - _EPS:
                            heapreplace(heap, (start + window, pid))
                            pending.append((base + j, g, window, 0))
                            pid_l.append(pid)
                            st_l.append(start)
                            du_l.append(window)
                            rj_l.append(True)
                            continue
                # fresh standalone pair: id known in advance (sequential),
                # opened in bulk after the loop; class 0 == the primary
                # cls_col already holds
                pid = pid_next + n_fresh
                n_fresh += 1
                th = th_l[g]
                heappush(heap, (t_now + th, pid))
                pid_l.append(pid)
                st_l.append(t_now)
                du_l.append(th)
                rj_l.append(False)
            if n_fresh:
                eng.open_pairs(np.zeros(n_fresh, dtype=np.int64))
            pid_col[i0:] = pid_l
            start_col[i0:] = st_l
            dur_col[i0:] = du_l
            readj_col[i0:] = rj_l

        # Alternate batch rounds with single scalar violators while batching
        # pays for itself; a round that nets only a few tasks (power-on
        # ramp, saturated frontier) costs more than the scalar rule, so
        # finish the group scalar from there.
        finish = finish_offline if (grain == 1 and not self.eng.server_mode
                                    and order_cols is None) else finish_scalar
        i = 0
        while i < k:
            consumed = batch_round(i)
            i += consumed
            if i >= k:
                break
            place_one(i)
            i += 1
            if consumed < 8:
                if i < k:
                    finish(i)
                break

        self._commit_group(gidx, pid_col, start_col, dur_col, readj_col,
                           cls_col)

    def place_group_select(self, idx, order, t_now: float, rule: str):
        """Pooled first-fit (``"ff"``) / best-fit (``"bf"``) placement for
        one ordered group (offline ``lpt-ff``/``edf-bf``, online
        Algorithm-6 first-fit).

        The per-task probes become array ops over the per-class compact
        pools — id-ascending, so ``argmax(fit)`` is exactly the scalar
        ``first_fit`` tie-break and ``argmax`` over the fit-masked ``mu``
        column is exactly ``best_fit`` — with the engine written once at
        the group commit.  Bit-identical to :meth:`place_group_scalar` by
        construction.
        """
        k = order.shape[0]
        if k == 0:
            return
        pre = self.pre
        gidx = np.asarray(idx)[order]
        gl = gidx.tolist()
        dl = self.deadline[gidx].tolist()
        prim = self.primary[gidx]
        t_hat_l = pre["t_hat_l"]
        order_cols = pre["order_cols"]
        best = rule == "bf"

        pid_col = np.empty(k, dtype=np.int64)
        start_col = np.empty(k)
        dur_col = np.empty(k)
        cls_col = np.empty(k, dtype=np.int64)
        gp = self._group_pools(t_now, pid_col, start_col, dur_col, cls_col)
        pool = gp.pool
        persistent = gp.persistent
        touched = gp.touched

        for i in range(k):
            g = gl[i]
            dd = dl[i]
            placed = False
            for c in (order_cols[g] if order_cols is not None else (0,)):
                ids, mus, n = pool(c)
                if not n:
                    continue
                th = t_hat_l[c][g]
                m = mus[:n]
                starts = np.maximum(t_now, m)
                fit = dd - starts >= th - _EPS
                if best:
                    if not fit.any():
                        continue
                    j = int(np.argmax(np.where(fit, m, -np.inf)))
                else:
                    j = int(np.argmax(fit))
                    if not fit[j]:
                        continue
                start = float(starts[j])
                mus[j] = start + th
                if persistent:
                    touched.setdefault(c, []).append(int(ids[j]))
                pid_col[i] = ids[j]
                start_col[i] = start
                dur_col[i] = th
                cls_col[i] = c
                placed = True
                break
            if not placed:
                gp.acquire(i, g, int(prim[i]))
        self._commit_group(gidx, pid_col, start_col, dur_col,
                           np.zeros(k, dtype=bool), cls_col)

    def place_group_scalar(self, idx, order, t_now: float, rule: str):
        """The per-task reference loop over the engine's own selectors:
        class preference order, worst fit (``"wf"``, with θ-readjustment
        when the context enables it) / best fit (``"bf"``) / first fit
        (``"ff"``), and the fresh-pair fallback.  The bit-identity oracle
        for the vectorized paths."""
        eng = self.eng
        cfgs = self.cfgs
        deadline = self.deadline
        order_cls = self.order_cls
        theta = self.theta
        readjust_on = self.readjust
        assignments = self.assignments
        pending = self.pending
        for r in order:
            gidx = int(idx[int(r)])
            d = deadline[gidx]

            placed = False
            for c in order_cls[:, gidx]:
                c = int(c)
                cfg_c = cfgs[c]
                t_hat = float(cfg_c.t_hat[gidx])
                if rule == "wf":
                    pid = eng.worst_fit(class_id=c)  # SPT: pair free first
                    if pid < 0:
                        continue
                    start = max(t_now, float(eng.mu[pid]))
                    if d - start >= t_hat - _EPS:
                        eng.assign(pid, start, t_hat)
                        assignments.append(make_assignment(
                            gidx, pid, start, cfg_c, class_id=c))
                        placed = True
                        break
                    elif readjust_on:
                        t_theta = max(theta * t_hat,
                                      float(cfg_c.t_min[gidx]))
                        window = d - start
                        if window >= t_theta - _EPS:
                            eng.assign(pid, start, window)
                            pending.append((len(assignments), gidx, window,
                                            c))
                            assignments.append(make_assignment(
                                gidx, pid, start, cfg_c, duration=window,
                                readjusted=True, class_id=c))
                            placed = True
                            break
                else:
                    pid = eng.best_fit(t_now, d, t_hat, class_id=c) \
                        if rule == "bf" \
                        else eng.first_fit(t_now, d, t_hat, class_id=c)
                    if pid >= 0:
                        start = max(t_now, float(eng.mu[pid]))
                        eng.assign(pid, start, t_hat)
                        assignments.append(make_assignment(
                            gidx, pid, start, cfg_c, class_id=c))
                        placed = True
                        break
            if not placed:
                c = int(self.primary[gidx])
                cfg_c = cfgs[c]
                pid = self.acquire_fresh(t_now, c)
                start = max(t_now, float(eng.mu[pid]))
                eng.assign(pid, start, float(cfg_c.t_hat[gidx]))
                assignments.append(make_assignment(gidx, pid, start, cfg_c,
                                                   class_id=c))

    def place_orphans(self, tids: np.ndarray, t_now: float, rule: str,
                      degrade=None) -> Tuple[int, int]:
        """Deadline-aware re-placement of tasks orphaned by a pair failure
        (the fault-recovery half of :mod:`repro_torch.core.faults`).

        One scalar loop shared verbatim by the scalar and vector placement
        modes — failures are rare events, so bit-identity between the modes
        under injection comes for free instead of by a second batched
        implementation.  Policy, in EDF order per orphan:

        * try the classes in the task's preference order with the normal
          pair rule (``"wf"`` worst fit for EDL, ``"ff"`` first fit for the
          bin baseline); a fit at the optimal length is placed like any
          arrival;
        * EDL only: when the worst-fit pair cannot host the optimal length,
          shrink to the remaining window ``d - start`` down to the class's
          ``t_min`` floor and queue the boundary re-solve on the shared
          deferred ``readjust_batch`` dispatch.  θ is deliberately ignored
          here — recovery prefers a deadline met at higher speed over a
          counted violation;
        * otherwise fall back to a fresh pair of the primary class; if even
          a fresh pair cannot meet the deadline, the *graceful degradation*
          step books the task anyway — at the ``degrade`` callback's
          max-speed setting (EDL) or the configured setting (bin) — so the
          miss is counted as a violation and a failure trace can never
          crash a run.

        Returns ``(n_restarted, n_degraded)``."""
        tids = np.asarray(tids, dtype=np.int64)
        if tids.size == 0:
            return 0, 0
        eng = self.eng
        cfgs = self.cfgs
        deadline = self.deadline
        assignments = self.assignments
        pending = self.pending
        n_degraded = 0
        order = np.argsort(deadline[tids], kind="stable")     # EDF
        for g in tids[order].tolist():
            d = float(deadline[g])
            placed = False
            for c in self.order_cls[:, g]:
                c = int(c)
                cfg_c = cfgs[c]
                t_hat = float(cfg_c.t_hat[g])
                if rule == "wf":
                    pid = eng.worst_fit(class_id=c)
                    if pid < 0:
                        continue
                    start = max(t_now, float(eng.mu[pid]))
                    window = d - start
                    if window >= t_hat - _EPS:
                        eng.assign(pid, start, t_hat)
                        assignments.append(make_assignment(
                            g, pid, start, cfg_c, class_id=c))
                        placed = True
                        break
                    if window >= float(cfg_c.t_min[g]) - _EPS:
                        eng.assign(pid, start, window)
                        pending.append((len(assignments), g, window, c))
                        assignments.append(make_assignment(
                            g, pid, start, cfg_c, duration=window,
                            readjusted=True, class_id=c))
                        placed = True
                        break
                else:
                    pid = eng.first_fit(t_now, d, t_hat, class_id=c)
                    if pid >= 0:
                        start = max(t_now, float(eng.mu[pid]))
                        eng.assign(pid, start, t_hat)
                        assignments.append(make_assignment(
                            g, pid, start, cfg_c, class_id=c))
                        placed = True
                        break
            if placed:
                continue
            c = int(self.primary[g])
            cfg_c = cfgs[c]
            t_hat = float(cfg_c.t_hat[g])
            pid = self.acquire_fresh(t_now, c)
            start = max(t_now, float(eng.mu[pid]))            # == t_now
            window = d - start
            if window < t_hat - _EPS:
                if rule == "wf" and window >= float(cfg_c.t_min[g]) - _EPS:
                    eng.assign(pid, start, window)
                    pending.append((len(assignments), g, window, c))
                    assignments.append(make_assignment(
                        g, pid, start, cfg_c, duration=window,
                        readjusted=True, class_id=c))
                    continue
                n_degraded += 1
                if rule == "wf" and degrade is not None:
                    v, fc, fm, t_run, p = degrade(g, c)
                    eng.assign(pid, start, t_run)
                    assignments.append(cl.Assignment(
                        task=g, pair=pid, start=start, finish=start + t_run,
                        v=v, fc=fc, fm=fm, power=p, energy=p * t_run,
                        class_id=c))
                    continue
            eng.assign(pid, start, t_hat)
            assignments.append(make_assignment(g, pid, start, cfg_c,
                                               class_id=c))
        return int(tids.size), n_degraded

    def binpack_offline_util(self, idx, order, t_now: float):
        """Algorithm 6, lines 1-7 (the online baseline's offline phase):
        worst-fit on task *utilization*, cap at 1.0.

        The *optimal task utilization* is ``u_hat = t_hat / (d - a)``; the
        worst-fit heuristic sends each task to the pair with the lowest
        current utilization (among pairs of the candidate class), opening a
        fresh pair of the task's primary class when no candidate fits.
        """
        eng = self.eng
        cfgs = self.cfgs
        deadline = self.deadline
        util = np.zeros(0)

        def grow():
            nonlocal util
            if util.shape[0] < eng.n_pairs:
                util = np.concatenate(
                    [util, np.zeros(eng.n_pairs - util.shape[0])])

        for r in order:
            gidx = int(idx[int(r)])
            d = deadline[gidx]
            grow()
            placed = False
            for c in self.order_cls[:, gidx]:
                c = int(c)
                cfg_c = cfgs[c]
                t_hat = float(cfg_c.t_hat[gidx])
                u_hat = t_hat / max(d - t_now, _EPS)
                on = eng.eligible_mask(class_id=c)
                if on is None:
                    on = np.ones(eng.n_pairs, dtype=bool)
                if not on.any():
                    continue
                pid = int(np.argmin(np.where(on, util[: eng.n_pairs],
                                             np.inf)))
                start = max(t_now, float(eng.mu[pid]))
                if util[pid] + u_hat > 1.0 + _EPS or d - start < t_hat - _EPS:
                    continue
                eng.assign(pid, start, t_hat)
                util[pid] += u_hat
                self.assignments.append(make_assignment(gidx, pid, start,
                                                        cfg_c, class_id=c))
                placed = True
                break
            if not placed:
                c = int(self.primary[gidx])
                cfg_c = cfgs[c]
                t_hat = float(cfg_c.t_hat[gidx])
                u_hat = t_hat / max(d - t_now, _EPS)
                pid = self.acquire_fresh(t_now, c)
                grow()
                start = max(t_now, float(eng.mu[pid]))
                eng.assign(pid, start, t_hat)
                util[pid] += u_hat
                self.assignments.append(make_assignment(gidx, pid, start,
                                                        cfg_c, class_id=c))
