"""Model FLOPs of the window's training steps (``bench/counts``: no
recompute) over the window's seconds at the card's bf16 peak, in %."""

import importlib

from bench.common import peaks


def read(rec):
    if rec["kind"] != "train":
        return None
    counts = importlib.import_module(f"bench.counts.{rec['family']}")
    flops = counts.train_step_flops(rec["model"], int(rec["mix"]["batch"]),
                                    int(rec["mix"]["seq"])) * rec["steps"]
    return 100.0 * flops / (rec["window_s"] * peaks.BF16_OPS)
