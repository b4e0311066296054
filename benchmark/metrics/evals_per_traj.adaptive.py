"""`evals_per_traj.dataset`'s reading in the adaptive cell, which reports
``traj_per_s.adaptive``: ``DatasetResults.evals`` plus the climb's
evaluations, per trajectory of the traced calls."""
from benchmark.metrics import _common


def read(rec):
    return _common.evals_per_traj(rec)
