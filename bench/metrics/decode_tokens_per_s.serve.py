"""Tokens generated in the window over the summed decode seconds of its
``Server.run`` calls (the host paces decode today)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return rec["tokens"] / sum(b["decode_s"] for b in rec["batches"])
