"""Per-layer readings from the port's own spans (``repro_torch.spans``),
which record only while a ``torch.profiler`` runs: in a run with
``--trace 1``, the traced sub-window's steps or batches.

A reading is a mean over the records of one span (a step) of the summed
milliseconds of another span's records beneath each.  Each reading is None
where the port has no spans (a checkout before them), where the traced
sub-window recorded no such step, or where a needed time is missing (no
CUDA events on the CPU).
"""

from __future__ import annotations

from typing import Optional


def program_records() -> Optional[list]:
    """The port's span records, or None where it has no spans."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.records()


def _ancestor(rec, name: str):
    while rec is not None and rec.name != name:
        rec = rec.parent
    return rec


def mean_within(records, name: str, within: str,
                clock: str = "device_ms") -> Optional[float]:
    """Mean over the ``within`` records of the summed ``clock``
    milliseconds (``device_ms`` or ``host_ms``) of the ``name`` records
    beneath each."""
    outer = [r for r in records or () if r.name == within]
    if not outer:
        return None
    sums = {id(r): 0.0 for r in outer}
    for r in records:
        if r.name != name:
            continue
        up = _ancestor(r.parent, within)
        if up is None or id(up) not in sums:
            continue
        ms = getattr(r, clock)
        if ms is None:
            return None
        sums[id(up)] += ms
    return sum(sums.values()) / len(outer)


def mean_host_outside(records, name: str, minus: str) -> Optional[float]:
    """Mean host milliseconds of the ``name`` records less those of their
    ``minus`` records."""
    own = [r.host_ms for r in records or () if r.name == name]
    if not own or None in own:
        return None
    inner = mean_within(records, minus, name, "host_ms")
    if inner is None:
        return None
    return sum(own) / len(own) - inner
