"""
The traced part of a ``--trace 1`` run: a `torch.profiler` window over the
device's activity, reduced in the process to busy time, device time by
kernel, host launch calls and the longest idle gaps. Nothing is written
to disk.

Frozen copies, at commit c0c4c56, of ``chip_smoke.py``'s `graph_profile`
and `device_time_by_name` (device events and host launch calls from the
raw CUDA-activity trace, ``LAUNCH_CALLS``) and `sample_time_split` (the host
clock around ``FixedkSampler.steps`` and ``__init__``, from outside). One
change: busy time is the union of the device events' intervals, not the
sum of their durations, so kernels that overlap on the samplers' streams
count once.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["LAUNCH_CALLS", "union_seconds", "idle_gaps", "DeviceWindow",
           "time_split"]

# host-side calls that put work on the device, as torch.profiler names them
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync")
TOP = 10


def union_seconds(intervals):
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def idle_gaps(intervals, host_calls, top=TOP):
    """The ``top`` longest gaps between the union's intervals, each as
    ``[what the host was doing, seconds]``: the host call (``(start_ns,
    end_ns, name)``) running at the gap's middle, else the last one that
    ended before it."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((a2 - b1, b1, a2) for (_, b1), (a2, _) in zip(merged, merged[1:])),
                  reverse=True)[:top]
    calls = sorted(host_calls)
    out = []
    for width, lo, hi in gaps:
        mid = (lo + hi) / 2
        during = [c for c in calls if c[0] <= mid <= c[1]]
        if during:
            label = f"host in {during[-1][2]}"
        else:
            before = [c for c in calls if c[1] <= mid]
            label = (f"host after {before[-1][2]}" if before
                     else "host before its first call")
        out.append([label, width / 1e9])
    return out


class DeviceWindow:
    """A profiler window over CUDA activity. `start` and `stop` bracket the
    traced part; `read` reduces it: ``{"busy_s", "window_s", "kernels":
    {name: [launches, seconds]}, "launch_calls", "device_ops",
    "idle_gaps"}``."""

    def __init__(self):
        self._prof = None
        self._t0 = self._t1 = None

    @staticmethod
    def warm():
        """Start and stop the profiler once on a tiny op, so that the
        traced part does not pay the tracer's first start."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        torch.cuda.synchronize()
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    @property
    def started(self):
        return self._prof is not None

    @property
    def running(self):
        return self.started and self._t1 is None

    def stop(self):
        torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def read(self):
        device, host = [], []
        kernels, by_name = {}, {}
        calls = 0
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            # each accessor is a call into the profiler's result: one apiece
            a, d, name = e.start_ns(), e.duration_ns(), e.name()
            if e.device_type() == cuda:
                device.append((a, a + d))
                n, s = by_name.get(name, (0, 0.0))
                by_name[name] = (n + 1, s + d / 1e9)
            else:
                host.append((a, a + d, name))
                if any(k in name for k in LAUNCH_CALLS):
                    calls += 1
        for name, (n, s) in by_name.items():
            kernels[name] = [n, s]
        ops = sorted(([name, s] for name, (_, s) in by_name.items()),
                     key=lambda x: -x[1])[:TOP]
        return {"busy_s": union_seconds(device), "window_s": self._t1 - self._t0,
                "kernels": kernels, "launch_calls": calls, "device_ops": ops,
                "idle_gaps": idle_gaps(device, host)}


@contextlib.contextmanager
def time_split(sampler_cls, spent):
    """Inside the block, add the host seconds spent in ``sampler_cls``'s
    `steps` (the AMIS steps, each ending in its one fetch) and `__init__`
    (construction and exhaustive enumeration) to ``spent["steps"]`` and
    ``spent["samplers"]``."""
    steps, init = sampler_cls.steps, sampler_cls.__init__

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    sampler_cls.steps, sampler_cls.__init__ = timed("steps", steps), timed("samplers", init)
    try:
        yield spent
    finally:
        sampler_cls.steps, sampler_cls.__init__ = steps, init
