"""A traced sub-window: ``torch.profiler`` over a few steps or batches, read
into device time by kernel, device busy time, and the idle gaps named by
what the host was doing.

Kernels are grouped as ``chip_smoke.device_split`` groups them (a copy of
its rule): the port's own kernels by name, matrix products by the cuBLAS and
CUTLASS names, everything else (element-wise work, reductions, copies).
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

#: Name fragments of the port's hand-written kernels.
PORT_KERNELS = ("flash_fwd", "flash_bwd", "ssd_fwd", "ssd_bwd", "dvfs_opt")
#: Name fragments of a matrix product's kernels (cuBLAS, CUTLASS).
MATMUL_KERNELS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
#: The harness's span around the traced work.
SPAN = "bench.traced"
#: Idle gaps named by the host's work, longest first.
NAMED_GAPS = 1000
TOP = 10


def group(name: str) -> str:
    """``"port"``, ``"matmul"`` or ``"rest"``."""
    if any(k in name for k in PORT_KERNELS):
        return "port"
    low = name.lower()
    if any(k in low for k in MATMUL_KERNELS):
        return "matmul"
    return "rest"


def traced(fn: Callable[[int], None], reps: int) -> dict:
    """Run ``fn(0) .. fn(reps - 1)`` under the profiler, the card
    synchronized before and after, and read the trace (:func:`reduce`)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for i in range(reps):
                fn(i)
            torch.cuda.synchronize()
    return reduce(prof.events())


def reduce(events) -> dict:
    """Device seconds by kernel, busy seconds (the union of the device's
    operations inside the span) against the span's seconds, both on the
    profiler's clock, and the top operations and idle gaps."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    span = None
    for e in events:
        tr = e.time_range
        if e.device_type == cuda:
            # A span of the host's (record_function) shows on the device's
            # timeline too: it is no operation of the card's.
            if not getattr(e, "is_user_annotation", False) and e.name != SPAN:
                dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
            if e.name == SPAN:
                span = (tr.start, tr.end)
    if not dev:
        raise RuntimeError("the profiler saw no device operation")
    if span is None:
        raise RuntimeError(f"the profiler lost the span {SPAN!r}")
    kernels: Dict[str, List[float]] = {}
    for name, s, e in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e6
        k[1] += 1
    # Busy time: the union of the device's intervals inside the span.
    iv = sorted((max(s, span[0]), min(e, span[1])) for _, s, e in dev
                if e > span[0] and s < span[1])
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    edges = [span[0]] + [x for se in merged for x in se] + [span[1]]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    return {"window_s": (span[1] - span[0]) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": kernels,
            "device_ops": top_ops(kernels),
            "idle_gaps": name_gaps(gaps[:NAMED_GAPS], host)}


def top_ops(kernels: Dict[str, List[float]]) -> list:
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[name[:160], sec] for name, (sec, _) in ops]


def name_gaps(gaps: list, host: list) -> list:
    """The gaps' seconds summed by the innermost host operation running at
    each gap's middle (``"idle"`` where none ran), the largest ``TOP``."""
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.float64)
    ends = np.array([h[2] for h in host], dtype=np.float64)
    out: Dict[str, float] = {}
    for length, s, e in gaps:
        mid = (s + e) / 2
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(cover):
            inner = cover[np.argmax(starts[cover])]
            name = names[inner][:160]
        else:
            name = "idle"
        out[name] = out.get(name, 0.0) + length / 1e6
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:TOP]


def split_s(kernels: Dict[str, List[float]]) -> Dict[str, float]:
    """Device seconds by :func:`group`."""
    out = {"port": 0.0, "matmul": 0.0, "rest": 0.0}
    for name, (sec, _) in kernels.items():
        out[group(name)] += sec
    return out


def matching(kernels: Dict[str, List[float]], fragment: str):
    """(seconds, launches) of the kernels whose name holds ``fragment``."""
    sec = n = 0
    for name, (s, c) in kernels.items():
        if fragment in name:
            sec += s
            n += c
    return sec, n
