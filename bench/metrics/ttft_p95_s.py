"""The 95th percentile (nearest rank) of the window's requests' time to
first token: each request's batch's prefill seconds (no queue in a closed
loop)."""

import math


def read(rec):
    if rec["kind"] != "serve" or not rec["ttft_s"]:
        return None
    t = sorted(rec["ttft_s"])
    return t[math.ceil(0.95 * len(t)) - 1]
