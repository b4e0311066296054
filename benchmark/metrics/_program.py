"""Arithmetic shared by the readers of the program's own spans and
counters: `bild_tpu_torch.utils.profiling.snapshot`, the record of the
latest profiler session, which is the traced part of the window. A
program that records no spans gives no snapshot, and its readers read
nothing."""
from __future__ import annotations


def snapshot():
    """The latest profiler session's snapshot, or None where it holds no
    call or the program has none."""
    from bild_tpu_torch.utils import profiling
    read = getattr(profiling, "snapshot", None)
    if read is None:
        return None
    snap = read()
    return snap if snap["calls"] else None


def total_s(snap, name):
    return snap["names"].get(name, {}).get("total_s", 0.0)


def count(snap, name):
    return snap["names"].get(name, {}).get("count", 0)


def per(part, whole, scale):
    return None if not whole else scale * part / whole


def counter_ratio(parts, whole, scale=1.0):
    """The summed deltas of counters ``parts`` over that of ``whole``."""
    snap = snapshot()
    if snap is None:
        return None
    c = snap["counters"]
    return per(sum(c.get(k, 0) for k in parts), c.get(whole, 0), scale)


def span_share(part, whole):
    """The time in spans ``part`` over the time in spans ``whole``, in
    percent."""
    snap = snapshot()
    if snap is None:
        return None
    return per(total_s(snap, part), total_s(snap, whole), 100.0)


def ms_per_span(name, per_name):
    """Milliseconds in spans ``name`` per span ``per_name``."""
    snap = snapshot()
    if snap is None:
        return None
    return per(total_s(snap, name), count(snap, per_name), 1e3)
