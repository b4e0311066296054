"""Likelihood evaluations per trajectory in a dataset cell's traced calls:
``DatasetResults.evals`` under the adaptive schedule, else
``run_lanes.lane_steps`` x N, plus the climb's
``optimize_boundary_batch.evaluations``. A count: it repeats exactly."""
from benchmark.metrics import _common


def read(rec):
    return _common.evals_per_traj(rec)
