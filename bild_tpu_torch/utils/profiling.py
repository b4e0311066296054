"""
Tracing and numerics debugging aids (counterpart of
`bild_tpu.utils.profiling`).

- `trace(logdir)`: context manager around `torch.profiler`; writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``) of host and,
  with a GPU, device execution under ``logdir``, the port's spans among
  its ranges.
- `span(name)`, `spanned(name)`: the port's spans at its layer boundaries
  (``sample`` ⊃ ``sample.decide``, ``sampler.init`` ⊃
  ``sampler.enumerate``, ``sampler.steps`` ⊃ ``run_steps``,
  ``sampler.fetch``; ``sample_dataset`` ⊃ ``dataset.chunk`` ⊃
  ``dataset.sample``, ``dataset.climb``; ``adaptive.round`` ⊃
  ``adaptive.decide``, ``run_steps``, ``adaptive.fetch``), recorded while
  a `torch.profiler` session records and only then (`bild_tpu_torch._spans`).
- `snapshot()`: the latest profiler session's spans, each span name's
  count, total and self time, and the deltas of the registered counters
  (`ops.counters`) over it. Each `trace` block starts a new log; two
  sessions opened directly with `torch.profiler` share one unless a span
  or `snapshot` ran between them with the profiler off.
- `strict_numerics()`: context manager around
  `torch.autograd.set_detect_anomaly`, the nearest PyTorch has to JAX's
  ``jax_debug_nans``.
"""
from __future__ import annotations

import contextlib
import os

import torch

from .. import _spans
from .._spans import snapshot, span, spanned

__all__ = ["trace", "span", "spanned", "snapshot", "strict_numerics"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; on exit write
    ``logdir/trace.json`` (Chrome trace format). Yields the
    `torch.profiler.profile` object, whose ``key_averages()`` can be read
    after the block. The block's spans start a new log, which `snapshot`
    reads after it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _spans.restart()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def strict_numerics(nans: bool = True):
    """
    Raise where a backward pass produces NaN
    (`torch.autograd.set_detect_anomaly`), with the traceback of the
    forward operation that made the failing gradient: for debugging the
    calibration objectives (`fit.fit_rouse`, `fit.fit_ggm`).

    What it does NOT catch: NaN or Inf made in a forward pass (the
    samplers and likelihoods run no backward at all), anything inside a
    CUDA kernel of this package, and anything replayed from a CUDA graph
    (the graphed calibration objective records its operations once).
    Several AMIS quantities are legitimately infinite or where-guarded NaN
    (log-densities of impossible states, 0 * inf in the KL accumulator),
    so a forward check would raise on correct runs. It slows autograd
    down severalfold.
    """
    with torch.autograd.set_detect_anomaly(nans):
        yield
