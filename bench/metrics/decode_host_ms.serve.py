"""Host milliseconds a decode step takes to issue its work: the
``serve.decode_step`` span less its ``serve.host_sync`` (the tokens' copy
to the host, where the host waits for the card), over the traced batches'
decode steps."""

from bench.common import spans


def read(rec):
    if rec["kind"] != "serve" or not rec.get("trace"):
        return None
    return spans.mean_host_outside(spans.program_records(),
                                   "serve.decode_step", "serve.host_sync")
