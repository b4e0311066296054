"""`graph_calls_per_step.dataset`'s reading in the adaptive cell, which
reports ``traj_per_s.adaptive``: graph replays plus buffer copies per AMIS
step (the bootstrap's lanes and every round's slots)."""
from benchmark.metrics import _program


def read(rec):
    return _program.counter_ratio(("graphs.replays", "graphs.copies"), "run_steps.steps")
