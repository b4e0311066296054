"""
The port's spans: named intervals of host work at its layer boundaries
(``sample``, ``sampler.steps``, ``run_steps``, ``sample_dataset``, ...),
recorded while a `torch.profiler` session records
(`torch.autograd._profiler_enabled`) and only then. With the profiler off
a span is that one check. Public as `utils.profiling.span`, `spanned` and
`snapshot`; a leaf module, so that the layers it marks can import it.

A recorded span keeps, in memory, its name, its start and end on the
profiler's own clock (`time.time_ns`), the index of the span that was open
around it and the id of its top-level call (the outermost recorded span
around it), and is opened as a profiler range of its name (PyTorch's
`_RecordFunctionFast`, the cheapest `record_function`), so a trace of the
session shows the program's layers beside the kernels. The stamps are
read just inside the range, where its own start and end are taken.

A session's log starts with the first span recorded after a span or
`snapshot` found the profiler off, or after `restart` (which
`utils.profiling.trace` calls on entry); two sessions opened directly with
`torch.profiler` and with none of these between them share one log. A
session records on the thread that opened it (`_profiler_enabled` is per
thread), so spans on other threads record nothing, and one stack of open
spans serves. The registered counters (`ops.counters`) are read when the
log starts and whenever a top-level call's span closes, so `snapshot`'s
deltas cover the session's calls.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

from .ops import counters

__all__ = ["span", "spanned", "snapshot", "restart"]

_enabled = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Log:
    """One session's spans: ``[name, start_ns, end_ns, parent, call]``
    each, in the order they opened (``end_ns`` None while open)."""

    def __init__(self):
        self.spans, self.open = [], []
        self.calls = 0
        self.first = self.last = counters.read()


_log = _Log()
_live = False      # whether `_log` is the session that is recording


class _Span:
    __slots__ = ("name", "log", "index", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _log, _live
        if not _live:
            _log, _live = _Log(), True
        self.log = log = _log
        if log.open:
            parent = log.open[-1]
            call = log.spans[parent][4]
        else:
            parent, call = None, log.calls
            log.calls += 1
        self.range = _Range(self.name)
        self.range.__enter__()
        self.index = len(log.spans)
        log.spans.append([self.name, time.time_ns(), None, parent, call])
        log.open.append(self.index)
        return self

    def __exit__(self, *exc):
        log = self.log
        log.spans[self.index][2] = time.time_ns()
        self.range.__exit__(*exc)
        log.open.pop()
        if not log.open:
            log.last = counters.read()
        return False


_OFF = contextlib.nullcontext()     # what `span` returns with the profiler off


def span(name: str):
    """A block recorded as span ``name`` while a profiler session records;
    otherwise a block that does nothing."""
    global _live
    if not _enabled():
        _live = False
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            block = span(name)
            if block is _OFF:
                return fn(*args, **kwargs)
            with block:
                return fn(*args, **kwargs)
        return wrapper
    return wrap


def restart() -> None:
    """Close the log: the next recorded span starts a new one."""
    global _live
    _live = False


def snapshot() -> dict:
    """
    The latest session's record, from its first span to the end of its
    last top-level call:

    - ``spans``: each span as ``{"name", "start_ns", "end_ns", "parent",
      "call"}`` (``parent`` an index into ``spans`` or None; a span still
      open has ``end_ns`` None and counts in no total);
    - ``names``: per span name ``{"count", "total_s", "self_s"}``, self time
      being the duration less what the span's children cover;
    - ``counters``: the registered counters' deltas over the session's
      top-level calls;
    - ``calls``: the number of top-level calls.

    Called with the profiler off, it also closes the log, so that the next
    recorded span starts a new one. Two sessions opened directly with
    `torch.profiler`, with no span or `snapshot` run between them with the
    profiler off, share one log; `utils.profiling.trace` starts its own.
    """
    global _live
    if not _enabled():
        _live = False
    log = _log
    spans = [{"name": n, "start_ns": a, "end_ns": b, "parent": p, "call": c}
             for n, a, b, p, c in log.spans]
    child_ns = [0] * len(spans)
    for s in spans:
        if s["parent"] is not None and s["end_ns"] is not None:
            child_ns[s["parent"]] += s["end_ns"] - s["start_ns"]
    sums = {}
    for s, inner in zip(spans, child_ns):
        if s["end_ns"] is not None:
            took = s["end_ns"] - s["start_ns"]
            n, total, own = sums.get(s["name"], (0, 0, 0))
            sums[s["name"]] = (n + 1, total + took, own + took - inner)
    names = {k: {"count": n, "total_s": total / 1e9, "self_s": own / 1e9}
             for k, (n, total, own) in sums.items()}
    return {"spans": spans, "names": names,
            "counters": {k: v - log.first.get(k, 0) for k, v in log.last.items()},
            "calls": log.calls}
