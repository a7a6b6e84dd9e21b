"""Counts shared by the families: live (query, key) pairs of causal
attention, and a kernel's least time from its operations and bytes."""

from __future__ import annotations

from typing import Optional

from bench.common import peaks


def live_pairs(S: int, window: Optional[int]) -> int:
    """Unmasked (query, key) pairs of one causal head over S positions,
    each query seeing the ``window`` keys up to its own (all of them
    without a window)."""
    W = S if not window or window >= S else window
    return W * (W + 1) // 2 + (S - W) * W


def least_s(ops: float, nbytes: float) -> float:
    """The least time of a kernel: its operations at the bf16 peak or its
    bytes at the HBM peak, whichever is longer."""
    return max(ops / peaks.BF16_OPS, nbytes / peaks.HBM_BYTES)
