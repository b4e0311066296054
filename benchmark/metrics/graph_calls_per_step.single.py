"""`graph_calls_per_step.dataset`'s reading in the ``sample()`` cell, which
reports ``sample_p95_s``: graph replays plus buffer copies per AMIS step
(each ``FixedkSampler.steps(n)`` call replays n steps after one set of
copies: ``init_runs`` steps for a new sampler, one for a decision)."""
from benchmark.metrics import _program


def read(rec):
    return _program.counter_ratio(("graphs.replays", "graphs.copies"), "run_steps.steps")
