"""
The port's counters, in one registry: the launches and plain calls of its
kernels, and the work of the layers above them.

Every kernel wrapper counts its launches, and every plain version its
calls, in an attribute of the function itself
(``msrouse_logL_sym.launches``, ``_solve_marginals.calls``); so do the
runners (``run_steps.steps``, ``run_lanes.lane_steps``), the step graphs
(``replay.replays``, ``replay.copies``), the adaptive rounds
(``sample_batch_adaptive.slot_steps``) and the climb
(``optimize_boundary_batch.evaluations``). `register` sets that attribute
to 0 and enters it under a name, next to the function's definition.
Whatever reads the counts takes the list from `COUNTERS`:
`parallel.graphs`, which adds a captured step's counts to every replay of
it (only the kernels' counters move inside a step), `utils.profiling`'s
`snapshot`, and the benchmark scripts. So a new counter is seen everywhere
once its module registers it.
"""
from __future__ import annotations

__all__ = ["COUNTERS", "register", "read", "reset"]

# name -> (function, attribute)
COUNTERS: dict = {}


def register(name: str, fn, attr: str) -> None:
    """Start ``fn.<attr>`` at 0 and enter it as counter ``name``."""
    setattr(fn, attr, 0)
    COUNTERS[name] = (fn, attr)


def read(names=None) -> dict:
    """``{name: count}`` of ``names`` (default: every counter)."""
    return {k: getattr(*COUNTERS[k]) for k in (COUNTERS if names is None else names)}


def reset(names=None) -> None:
    """Set ``names`` (default: every counter) to 0."""
    for k in (COUNTERS if names is None else names):
        fn, attr = COUNTERS[k]
        setattr(fn, attr, 0)
