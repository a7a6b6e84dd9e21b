"""Device milliseconds a training step outside the matrix products and the
port's hand-written kernels (element-wise work, reductions, copies), over
the traced steps."""

from bench.common import trace


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    return 1e3 * trace.split_s(t["kernels"])["rest"] / t["steps"]
