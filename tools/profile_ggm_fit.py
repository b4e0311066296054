#!/usr/bin/env python3
"""
Where one step of the GGM calibration objective spends its time on the GPU.

    python3 tools/profile_ggm_fit.py          (from the repository root)

Builds `fit_ggm.make_ggm_nll` on config 6 of bench_e2e.py (two-state
two-locus Rouse, 64 trajectories of 100 frames, at their true profiles;
made by `chip_smoke.ggm_config`) and prints, for the table gather's own
backward (`fit_ggm._LagGather`) and for autograd's index backward in its
place: the wall and device time of one eager forward + backward, the number
of device operations, and the five operations with the most device time.
Then the wall of `fit_ggm` at 100 and 300 Adam steps, with the objective
replayed as one CUDA graph (what the package does) and eagerly.

Prints the card's name and power limit first. Needs one CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bild_tpu_torch as bt  # noqa: E402
import chip_smoke  # noqa: E402
from bild_tpu_torch import fit, fit_ggm  # noqa: E402

SPEC = [[("twoLocusRouse", dict(G=1.2, J=4.0), 0.1, 0)],
        [("twoLocusRouse", dict(G=0.16, J=1.2), 0.1, 0)]]


def one_step(batch, truths, steps=5):
    nll, p0 = fit_ggm.make_ggm_nll(SPEC, batch, truths)
    leaves = {s: {k: v.clone().requires_grad_(True) for k, v in e.items()}
              for s, e in p0.items()}

    def step():
        nll(leaves).backward()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    by_name = chip_smoke.device_time_by_name(prof)
    busy = sum(ms for ms, _ in by_name.values()) / steps
    events = sum(c for _, c in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return wall * 1e3, busy, events, [(n, ms / steps, c / steps) for n, (ms, c) in top]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_ggm_fit.py: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _, truths, _, _, batch = chip_smoke.ggm_config(bt, 6)
    fit.fit_ggm(SPEC, batch, truths, steps=2)      # library start-up

    own = fit_ggm._LagGather.apply
    variants = (("fit_ggm._LagGather", own),
                ("autograd's index backward", lambda table, idx, bins: table[idx]))
    for name, gather in variants:
        fit_ggm._LagGather.apply = gather
        wall, busy, events, top = one_step(batch, truths)
        print(f"objective step, {name}: wall {wall:.3f} ms, device {busy:.3f} "
              f"ms, {events:.0f} device operations", flush=True)
        for op, ms, cnt in top:
            print(f"    {ms:9.3f} ms {cnt:6.1f}x  {op[:100]}", flush=True)
    fit_ggm._LagGather.apply = own

    capture = torch.cuda.make_graphed_callables
    for name, graphed in (("one CUDA graph", capture),
                          ("eager", lambda fn, args: fn)) * 2:
        torch.cuda.make_graphed_callables = graphed
        for steps in (100, 300):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit.fit_ggm(SPEC, batch, truths, steps=steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"fit_ggm {steps} steps, objective {name}: wall {wall:.3f} s "
                  f"({wall / steps * 1e3:.3f} ms per step, the objective's "
                  f"build included), nll {res.nll_trace[0]:.5f} -> "
                  f"{res.nll_trace[-1]:.5f}", flush=True)
    torch.cuda.make_graphed_callables = capture


if __name__ == "__main__":
    main()
