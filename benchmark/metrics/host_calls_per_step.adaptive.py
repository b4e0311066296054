"""`host_calls_per_step.dataset`'s reading in the adaptive cell, which
reports ``traj_per_s.adaptive``: host calls that put work on the device,
over the whole traced calls, per AMIS step."""
from benchmark.metrics import _common


def read(rec):
    return _common.host_calls_per_step(rec)
