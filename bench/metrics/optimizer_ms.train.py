"""Device milliseconds a training step inside the port's span
``train.optimizer`` (AdamW's update over every leaf), over the traced
steps: stream time from the span's first CUDA event to its last.  It is
read only in the danube cells, where the card leads the host into the
update and the stream time stays near the update's kernel time; where the
host paces the update (mamba2) it would read the host's time."""

from bench.common import spans


def read(rec):
    if rec["kind"] != "train" or not rec.get("trace"):
        return None
    return spans.mean_within(spans.program_records(), "train.optimizer",
                             "train.step")
