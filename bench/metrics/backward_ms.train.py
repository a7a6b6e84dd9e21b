"""Device milliseconds a training step inside the port's span
``train.backward`` (``torch.autograd.grad``, each layer's remat recompute
included), summed over a step's microbatches, over the traced steps:
stream time between the span's CUDA events, read in the cells whose
backward the card paces (danube's)."""

from bench.common import spans


def read(rec):
    if rec["kind"] != "train" or not rec.get("trace"):
        return None
    return spans.mean_within(spans.program_records(), "train.backward",
                             "train.step")
