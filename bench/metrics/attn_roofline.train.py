"""The attention kernels' share of their roofline in the traced training
steps: the summed least time of every forward and backward call
(``bench/counts``) over the summed device time of their launches, in %."""

import importlib

from bench.common import trace


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    fwd_s, n_fwd = trace.matching(t["kernels"], "flash_fwd")
    bwd_s, _ = trace.matching(t["kernels"], "flash_bwd")
    _, n_bwd = trace.matching(t["kernels"], "flash_bwd_dq")
    if not n_fwd or not n_bwd:
        return None
    counts = importlib.import_module(f"bench.counts.{rec['family']}")
    B, S = int(rec["mix"]["batch"]), int(rec["mix"]["seq"])
    bound = (n_fwd * counts.attention_fwd_bound_s(rec["model"], B, S, True)
             + n_bwd * counts.attention_bwd_bound_s(rec["model"], B, S))
    return 100.0 * bound / (fwd_s + bwd_s)
