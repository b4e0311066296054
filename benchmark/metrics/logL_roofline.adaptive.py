"""`logL_roofline.lockstep`'s reading in the adaptive cell, which reports
``traj_per_s.adaptive``: the Rouse likelihood's least time over the device
time of its launches, in percent."""
from benchmark.metrics import _common


def read(rec):
    return _common.roofline(rec)
