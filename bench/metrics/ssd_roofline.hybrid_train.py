"""The SSD kernels' share of their roofline in the traced training steps of
the hybrid cell: the summed least time of every scan and backward call
(``bench/counts``, operands only, at the cell's own heads and length) over
the summed device time of their launches, in %.  Read where the card paces
the step, so the SSD kernels' time is the hybrid's own."""

import importlib

from bench.common import trace


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    fwd_s, n_fwd = trace.matching(t["kernels"], "ssd_fwd")
    bwd_s, _ = trace.matching(t["kernels"], "ssd_bwd")
    _, n_bwd = trace.matching(t["kernels"], "ssd_bwd_state")
    if not n_fwd or not n_bwd:
        return None
    counts = importlib.import_module(f"bench.counts.{rec['family']}")
    B, S = int(rec["mix"]["batch"]), int(rec["mix"]["seq"])
    bound = (n_fwd * counts.ssd_fwd_bound_s(rec["model"], B, S)
             + n_bwd * counts.ssd_bwd_bound_s(rec["model"], B, S))
    return 100.0 * bound / (fwd_s + bwd_s)
