"""The attention kernel's share of its roofline in the traced prefills: the
summed least time of every call (``bench/counts``, at each batch's padded
length) over the summed device time of its launches, in %."""

import importlib

from bench.common import trace


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t:
        return None
    fwd_s, n_fwd = trace.matching(t["kernels"], "flash_fwd")
    if not n_fwd:
        return None
    counts = importlib.import_module(f"bench.counts.{rec['family']}")
    per_batch = n_fwd / len(t["batches"])
    bound = sum(per_batch * counts.attention_fwd_bound_s(
        rec["model"], len(b["lengths"]), b["s0"], False) for b in t["batches"])
    return 100.0 * bound / fwd_s
