"""The card's energy over the window (NVML) over the tokens trained
(training) or generated (serving) in it."""


def read(rec):
    if not rec["tokens"]:
        return None
    return rec["energy_j"] / rec["tokens"]
