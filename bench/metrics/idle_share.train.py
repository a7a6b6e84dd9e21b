"""The share of the traced sub-window in which no operation ran on the
card, in %: 1 - device busy seconds (the union of its operations' spans)
over the sub-window's host seconds."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
