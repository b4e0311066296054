"""The share of ``sample()``'s wall outside the AMIS steps and the
samplers' construction (the choice loop over k on the host), in the traced
calls, in percent."""


def read(rec):
    if not rec.get("calls_s"):
        return None
    return 100.0 * (rec["calls_s"] - rec["steps_s"] - rec["samplers_s"]) / rec["calls_s"]
