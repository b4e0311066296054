"""
CUDA graphs of the dataset runners' AMIS step: the counterpart of the
compiled programs of `bild_tpu` (`jax.jit` around a `lax.fori_loop` of
steps, `bild_tpu.parallel.batch` l.305-352 and `bild_tpu.infer.adaptive`
l.255-263).

On CUDA a runner (`parallel.batch.run_lanes`, `infer.adaptive.run_slots`,
and `amis.FixedkSampler.steps`, the lockstep step at one lane that
`sample()` runs; all through `parallel.batch.run_steps`) replays one
graph of its step for every step. Where no graph of its shapes is cached it first runs one step
eagerly, which builds every kernel, table and plan the step needs; then
`replay` captures one step on a side stream into a graph on fixed
buffers (a capture launches nothing) and replays it. A step reads
nothing back to the host: its random tags come from the state's device
step counts, and the gamma sampler's rejection rounds and the CFC solve
are kernels that loop on the device. The capture runs under
``torch.cuda.set_sync_debug_mode("error")``, so a step that would ask the
device anything fails to capture, and the runner raises: there is no
quiet fallback to the eager loop. A replay launches what the eager step
launches, kernel for kernel, so the two give the same bits.
Each replay adds the captured step's counts to the launch and plain-call
counters (`ops.counters`), so they read as after the eager loop.

Graphs are cached per step shape (every tensor's shape, type and device),
the runner's constants and the model's likelihood closure, at most
`_GRAPHS_MAX` (a sampler's per-k numbers, the log-prior and the slot
mask, are tensors among its inputs and not constants, so that every
sampler of one `sample()` replays one graph); building a graph for another closure (another model,
kernel or tier) frees the others first, and `clear` frees all. A graph
holds its own copies of the state and inputs (copied in before its
replays, the state copied out after) and a private memory pool of one
step's temporaries for its life. The graphs outlive the runner's call, so
that the next call of the same shapes (a chunk, a round, a later
`sample_batch` on the same model) replays at once; `clear` gives their
memory back.

The CPU runs the eager loop. So does CUDA while the private `_EAGER` is
true: the tests and ``chip_smoke.py`` set it to compare the two modes.
"""
from __future__ import annotations

import collections

import torch

from ..ops import counters

__all__ = ["graphed", "cached", "replay", "clear"]

_EAGER = False
_GRAPHS_MAX = 8
_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()


def graphed(device) -> bool:
    """Whether a runner on ``device`` replays a CUDA graph of its step."""
    return torch.device(device).type == "cuda" and not _EAGER


def _capture(fn):
    """Capture ``fn()`` into a CUDA graph on a side stream, failing on any
    synchronization of this thread (other threads, such as a process
    group's watchdog, may go on querying the device); returns the graph's
    replay."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        prior = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prior)
    return graph.replay


def _flatten(args):
    """The tensors of ``args`` (tensors, tuples of tensors or other values)
    and a key of the rest."""
    tensors, key = [], []
    for a in args:
        if isinstance(a, torch.Tensor):
            tensors.append(a)
            key.append("T")
        elif isinstance(a, tuple) and all(isinstance(x, torch.Tensor) for x in a):
            tensors.extend(a)
            key.append(len(a))
        else:
            key.append(("C", a))
    return tensors, tuple(key)


def _unflatten(tensors, key):
    it = iter(tensors)
    out = []
    for k in key:
        if k == "T":
            out.append(next(it))
        elif isinstance(k, int):
            out.append(tuple(next(it) for _ in range(k)))
        else:
            out.append(k[1])
    return out


class _StepGraph:
    """One captured ``step(mutable, scratch, *args)`` on fixed buffers."""

    def __init__(self, step, mutable, tensors, shape, scratch):
        self.mutable = [t.clone() for t in mutable]
        self.inputs = [t.clone() for t in tensors]
        self.scratch = [torch.empty_like(t) for t in scratch]
        args = _unflatten(self.inputs, shape)
        before = counters.read()
        self._replay = _capture(lambda: step(self.mutable, self.scratch, *args))
        # the capture launched nothing: its counts belong to each replay
        after = counters.read()
        self.counts = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
        for k in self.counts:
            fn, attr = counters.COUNTERS[k]
            setattr(fn, attr, before.get(k, 0))

    def run(self, mutable, tensors, n):
        for dst, src in zip(self.inputs, tensors):
            dst.copy_(src)
        for dst, src in zip(self.mutable, mutable):
            dst.copy_(src)
        for _ in range(n):
            self._replay()
            for k, v in self.counts.items():
                fn, attr = counters.COUNTERS[k]
                setattr(fn, attr, getattr(fn, attr) + v)
        for dst, src in zip(mutable, self.mutable):
            dst.copy_(src)


def _key(kind, owner, mutable, args, scratch):
    tensors, shape = _flatten(args)
    return tensors, shape, (kind, owner, shape, tuple(
        (tuple(t.shape), t.dtype, t.device)
        for t in (*mutable, *tensors, *scratch)))


def cached(kind, owner, mutable, args, scratch=()) -> bool:
    """Whether `replay` holds a graph for these arguments."""
    return _key(kind, owner, mutable, args, scratch)[2] in _GRAPHS


def replay(kind, owner, step, mutable, args, n, scratch=()) -> None:
    """
    ``n`` calls of ``step(mutable, scratch, *args)`` as replays of one
    cached CUDA graph. ``mutable``: the tensors the step updates in place
    (copied into the graph's buffers first and back out after);
    ``args``: tensors or tuples of tensors (copied into its inputs) and
    other values (part of the cache key, with ``kind`` and ``owner``, the
    model's likelihood closure); ``scratch``: tensors whose shapes the step
    uses as work buffers. The caller has run the step eagerly at least once
    on these shapes. Counts captures in ``replay.captures``, replayed
    steps in ``replay.replays`` and the tensor copies into and out of the
    graph's buffers in ``replay.copies``.
    """
    tensors, shape, key = _key(kind, owner, mutable, args, scratch)
    graph = _GRAPHS.pop(key, None)
    if graph is None:
        for other in [k for k in _GRAPHS if k[1] is not owner]:
            del _GRAPHS[other]
        while len(_GRAPHS) >= _GRAPHS_MAX:
            _GRAPHS.popitem(last=False)
        graph = _StepGraph(step, mutable, tensors, shape, scratch)
        replay.captures += 1
    _GRAPHS[key] = graph                 # most recently used last
    graph.run(mutable, tensors, n)
    replay.replays += n
    replay.copies += len(graph.inputs) + 2 * len(graph.mutable)


counters.register("graphs.captures", replay, "captures")
counters.register("graphs.replays", replay, "replays")
counters.register("graphs.copies", replay, "copies")


def clear() -> None:
    """Free every cached graph and its memory pool."""
    _GRAPHS.clear()
