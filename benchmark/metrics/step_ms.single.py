"""Host milliseconds per AMIS step of ``sample()``: the host clock around
``FixedkSampler.steps`` (each ends in its one fetch, so the step's device
work ends inside it), over the steps, in the traced calls."""


def read(rec):
    if not rec["amis_steps"]:
        return None
    return rec["steps_s"] / rec["amis_steps"] * 1e3
