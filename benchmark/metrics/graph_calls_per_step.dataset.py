"""The step graphs' host calls per AMIS step in the dataset cells' traced
calls, from the program's counters: graph replays plus the tensor copies
into and out of the graphs' buffers (``graphs.replays`` +
``graphs.copies``, `parallel.graphs.replay`), over the steps
(``run_steps.steps``). A count: it repeats exactly."""
from benchmark.metrics import _program


def read(rec):
    return _program.counter_ratio(("graphs.replays", "graphs.copies"), "run_steps.steps")
