"""
Tracing and numerics debugging aids (counterpart of
`bild_tpu.utils.profiling`).

- `trace(logdir)`: context manager around `torch.profiler`; writes a
  Chrome trace (open it in Perfetto or ``chrome://tracing``) of host and,
  with a GPU, device execution under ``logdir``.
- `strict_numerics()`: context manager around
  `torch.autograd.set_detect_anomaly`, the nearest PyTorch has to JAX's
  ``jax_debug_nans``.
"""
from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["trace", "strict_numerics"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; on exit write
    ``logdir/trace.json`` (Chrome trace format). Yields the
    `torch.profiler.profile` object, whose ``key_averages()`` can be read
    after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
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
