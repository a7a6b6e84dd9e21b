"""Prefill model FLOPs of the window's requests over their own tokens (no
pads; ``bench/counts``) over the summed prefill seconds at the card's bf16
peak, in %."""

import importlib

from bench.common import peaks


def read(rec):
    if rec["kind"] != "serve":
        return None
    counts = importlib.import_module(f"bench.counts.{rec['family']}")
    flops = sum(counts.prefill_flops(rec["model"], b["lengths"])
                for b in rec["batches"])
    seconds = sum(b["prefill_s"] for b in rec["batches"])
    return 100.0 * flops / (seconds * peaks.BF16_OPS)
