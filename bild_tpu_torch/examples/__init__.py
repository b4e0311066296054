"""
Runnable examples of bild_tpu_torch, one module each; they do what the
repository's ``examples/*.py`` do with `bild_tpu`, step for step, and print
the same labelled lines:

    python -m bild_tpu_torch.examples.single_trajectory [--device cpu] [--smoke]
    python -m bild_tpu_torch.examples.infer_dataset [tracks.csv] [--device cpu] [--smoke]
    python -m bild_tpu_torch.examples.calibrate_params [--device cpu] [--smoke]
    python -m bild_tpu_torch.examples.ggm_model [--device cpu] [--smoke]

Each module has ``main(device=None, smoke=None)``, which returns a dict of
what it printed. ``device=None`` runs on the GPU and raises without one
(`config.resolve_device`); ``device="cpu"`` runs on the CPU. The GPU runs
in float32, the CPU in float64 (as the port's CPU tests do). ``smoke=None``
reads ``BILD_SMOKE=1`` (tiny shapes, as `bild_tpu`'s examples do). Every
random draw comes from an explicit `torch.Generator` (or, where
`bild_tpu`'s example draws from a numpy Generator, from the same one).
"""
from __future__ import annotations

import argparse
import os

import torch

from ..config import DEFAULT_DEVICE, resolve_device


def setup(device, smoke):
    """``(device, dtype, smoke)`` for an example's ``main``: the GPU unless
    ``device`` says otherwise, float32 there and float64 on the CPU, and
    ``smoke`` from ``BILD_SMOKE=1`` when it is ``None``."""
    device = resolve_device(DEFAULT_DEVICE if device is None else device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    if smoke is None:
        smoke = os.environ.get("BILD_SMOKE") == "1"
    return device, dtype, bool(smoke)


def parse_args(description, argv=None, csv=False):
    """The examples' command line: ``[csv] [--device D] [--smoke]``."""
    parser = argparse.ArgumentParser(description=description)
    if csv:
        parser.add_argument("csv", nargs="?", default=None,
                            help="a trajectory table (traj_id,frame,x1,..); "
                                 "synthesized data if omitted")
    parser.add_argument("--device", default=None,
                        help="'cpu' or a CUDA device (default: the GPU)")
    parser.add_argument("--smoke", action="store_true", default=None,
                        help="tiny shapes (default: BILD_SMOKE=1)")
    return parser.parse_args(argv)
