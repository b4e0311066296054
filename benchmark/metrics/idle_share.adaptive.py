"""`idle_share.lockstep`'s reading in the adaptive cell, which reports
``traj_per_s.adaptive``: 1 - the union of the device events' intervals over
the traced wall, in percent."""
from benchmark.metrics import _common


def read(rec):
    return _common.idle(rec)
