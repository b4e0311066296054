"""The mean wall of one ``sample()`` call over the traced calls, in
milliseconds: it moves with the rare calls whose samplers run to
``max_fev`` while two switch counts stay tied, which the tail's
percentile does not see."""


def read(rec):
    if not rec["calls"]:
        return None
    return rec["calls_s"] / rec["calls"] * 1e3
