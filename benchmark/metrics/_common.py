"""Arithmetic shared by the metric readers. Which cells a metric reads is
``BENCHMARK.json``'s ``workloads`` alone."""
from __future__ import annotations

import json
from pathlib import Path

from benchmark import work

KERNELS = Path(__file__).resolve().parent.parent / "kernels"


def kernel_seconds(rec, listing):
    """Device seconds of the traced kernels whose names hold a substring of
    ``kernels/<listing>.json``."""
    names = json.loads((KERNELS / f"{listing}.json").read_text())["names"]
    return sum(s for name, (_, s) in rec["kernels"].items()
               if any(k in name for k in names))


def roofline(rec):
    device_s = kernel_seconds(rec, "rouse_logL")
    if device_s <= 0 or not rec["profiles"]:
        return None
    z = rec["sizes"]
    least, _ = work.least_seconds(rec["profiles"], z["n"], z["N"], z["d"], z["q"])
    return 100.0 * least / device_s


def idle(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def evals_per_traj(rec):
    if not rec["trajectories"]:
        return None
    return rec["evals"] / rec["trajectories"]


def host_calls_per_step(rec):
    if not rec["amis_steps"]:
        return None
    return rec["launch_calls"] / rec["amis_steps"]
