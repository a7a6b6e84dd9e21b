"""Spans: named intervals of the port's host work at each layer boundary,
timed on the host's clock and, where asked, on the card's.

    with spans.span("train.optimizer", timed=True) as s:
        ...
    spans.records()     # after a synchronize: each record's host_ms, device_ms

A span is on exactly while a ``torch.profiler`` runs (torch's own flag,
``torch.autograd.profiler._is_profiler_enabled``); there is no other
switch.  Off, :func:`span` returns one shared null context, whose ``as``
value is None: no record, no ``record_function``, no CUDA event.  On, a
span

* enters ``torch.profiler.record_function(name)``, so that the profiler's
  trace shows it as a host event above the kernels it launched (an
  exported trace ties each kernel to it through the launch's correlation
  id);
* appends a :class:`Span` to a bounded buffer (the newest :data:`LIMIT`
  records): its name, attrs, parent span, thread and host start and end
  (``time.perf_counter_ns``).  A ``timed`` span, where CUDA is initialised
  and no ``FakeTensorMode`` runs, also records a pair of CUDA events on
  the current stream at entry and exit.  ``device_ms`` is the stream time
  between the two: the span's device work plus any time the stream waited
  for the host inside it, so it is the card's time only where the card
  sets the pace (the backward and the update of a card-bound model's
  step); a span whose work the host issues more slowly than the card runs
  it reads the host's time.  The events cost tens of microseconds a span
  under the profiler, so only those two spans ask for them.

Each thread keeps its own stack of open spans.  A span opened on a thread
with none open (the autograd engine's device thread, which runs the
backward and the remat recompute) takes as parent the newest open span of
another thread: ``train.backward`` for the recompute's layers.

Spans read no tensor and change no value.  The names, their attrs and
what each serves are listed in ``PERF.md`` (§3).

The buffer is one per process, as the profiler it follows is.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

#: Records kept: the newest ``LIMIT``.
LIMIT = 1 << 17

_lock = threading.Lock()
_buffer: collections.deque = collections.deque()
_local = threading.local()
#: Each thread's stack of open spans, by thread ident.
_stacks: Dict[int, list] = {}
#: Free (start, end) CUDA event pairs.
_pool: List[tuple] = []


class _Null:
    """The span when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = stack = []
        _stacks[threading.get_ident()] = stack
        return stack


def _adopted_parent() -> Optional["Span"]:
    """The newest open span of any thread (for a thread with none open)."""
    best = None
    for stack in list(_stacks.values()):
        try:
            top = stack[-1]
        except IndexError:
            continue
        if best is None or top.start_ns > best.start_ns:
            best = top
    return best


def _on_card() -> bool:
    return (torch.cuda.is_initialized() and torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is None)


def _event_pair() -> tuple:
    with _lock:
        if _pool:
            return _pool.pop()
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


class Span:
    """One span's record (also its context manager while it is open)."""

    __slots__ = ("name", "attrs", "parent", "thread", "start_ns", "end_ns",
                 "timed", "_rf", "_events", "_ms")

    def __init__(self, name: str, attrs: Dict[str, Any], timed: bool = False):
        self.name = name
        self.attrs = attrs
        self.parent: Optional[Span] = None
        self.thread = threading.get_ident()
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.timed = timed
        self._events = None
        self._ms: Optional[float] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1] if stack else _adopted_parent()
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        if self.timed and _on_card():
            self._events = _event_pair()
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        with _lock:
            _buffer.append(self)
            if len(_buffer) > LIMIT:
                _release(_buffer.popleft())
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(*exc)
        self._rf = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    @property
    def host_ms(self) -> Optional[float]:
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Stream milliseconds from the entry event to the exit event
        (waits for the exit event); None without events or while open."""
        if self._ms is None and self._events is not None and \
                self.end_ns is not None:
            start, end = self._events
            end.synchronize()
            self._ms = start.elapsed_time(end)
        return self._ms


def _release(rec: Span) -> None:
    """Resolve a closed record's device time where its events have
    completed, and return the events to the pool (under ``_lock``)."""
    if rec._events is None or rec.end_ns is None:
        return
    start, end = rec._events
    if rec._ms is None and end.query():
        rec._ms = start.elapsed_time(end)
    rec._events = None
    _pool.append((start, end))


def span(name: str, timed: bool = False, **attrs):
    """A context manager that records ``name`` with ``attrs`` while a
    ``torch.profiler`` runs, with CUDA events where ``timed``; its ``as``
    value is the :class:`Span` (whose ``attrs`` the caller may add to) or
    None."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name, attrs, timed)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(name, {}):
                return fn(*args, **kwargs)

        return inner

    return wrap


def records() -> List[Span]:
    """The buffered records, oldest first (resolve ``device_ms`` after a
    synchronize of the stream)."""
    with _lock:
        return list(_buffer)


def clear() -> None:
    """Empty the buffer; records already handed out keep their times."""
    with _lock:
        for rec in _buffer:
            _release(rec)
        _buffer.clear()
