"""Seconds from the process's start to the window's: torch's import, the
card's context, the weights made on the card, kernels loaded (built on a
checkout's first run), the set-up steps or batches."""


def read(rec):
    return rec["setup_s"]
