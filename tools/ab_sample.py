#!/usr/bin/env python3
"""
Single-trajectory `sample()` runs for one checkout of the port, to compare
two commits on the same GPU:

    python3 tools/ab_sample.py TREE

``TREE`` is the root of a checkout (e.g. a `git archive` of another
commit unpacked into a git-ignored directory); its `bild_tpu_torch`,
`bench_torch.py` and `bench_e2e_torch.py` are imported. The cases and the
trace are those of this checkout's `chip_smoke.py` (`readme_case`,
`ggm_sample_case`, `IIDGaussianModel`, `graph_profile`), loaded from its
file:

- ``readme sym``, ``readme dense``: the README `sample()` under each
  kernel selector (generator seed 7);
- ``ggm_model``: the `ggm_model` example's `sample()`;
- ``custom``: a user-defined model (`IIDGaussianModel`, no
  ``lockstep_fns``) on a T=100 trajectory with a loop at frames 30-60
  (numpy seed 7), `sample()` with its defaults (generator seed 11);
- ``readme cpu``: the README `sample()` with model and trajectory on the
  CPU (two calls, no trace);
- ``custom exact``: ``custom`` with the lane-exact sums that its eager
  step leaves out (where the tree's `lane_step` takes ``exact``; from
  this case on every step takes them).

Per case on the GPU: the wall of the process's first call and of three
more, and one traced call's device-busy share, host launch calls per AMIS
step and each hand kernel's launches and device time; where the tree's
step graphs count their copies (`graphs.replay.copies`), the copies per
AMIS step. Prints the card's name and power limit, then one JSON line per
case. The first call of a process pays the kernel build (if the tree has
none yet) and one-time warm-up; compare the later calls. To compare two
commits, run both in one call to the GPU in the order A, B, B, A.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bild_tpu_torch as bt  # noqa: E402
from bild_tpu_torch.parallel import batch, graphs  # noqa: E402

if not bt.__file__.startswith(tree):
    raise SystemExit(f"imported {bt.__file__}, not the tree {tree}")
if not torch.cuda.is_available():
    raise SystemExit("ab_sample.py: no CUDA device")
spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)

card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                       "--format=csv,noheader"], capture_output=True, text=True,
                      check=True).stdout.strip()
print(card, flush=True)
bt.config.exact_fp32()


def readme(device):
    if device == "cpu":
        smoke.DEVICE = "cpu"
    try:
        model, true, traj = smoke.readme_case(bt)
    finally:
        smoke.DEVICE = "cuda"
    return (lambda: bt.sample(traj, model, generator=torch.Generator(
        device=device).manual_seed(7))), true


def custom():
    rng = np.random.default_rng(7)
    true = np.zeros(smoke.T, dtype=int)
    true[30:60] = 1
    y = np.array([0.0, 3.0])[true] + 0.6 * rng.normal(size=smoke.T)
    model = smoke.IIDGaussianModel(host=False)
    return (lambda: bt.sample(y, model, generator=torch.Generator(
        device="cuda").manual_seed(11))), true


def custom_exact():
    real = batch.lane_step
    batch.lane_step = lambda *args: real(*args[:14], True)
    return custom()


def timed(run, device):
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    if device == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


cases = [("readme sym", "sym", "cuda", lambda: readme("cuda")),
         ("readme dense", "dense", "cuda", lambda: readme("cuda")),
         ("ggm_model", "sym", "cuda", lambda: smoke.ggm_sample_case(bt)),
         ("custom", "sym", "cuda", custom),
         ("readme cpu", "sym", "cpu", lambda: readme("cpu"))]
if "exact" in inspect.signature(batch.lane_step).parameters:
    cases.append(("custom exact", "sym", "cuda", custom_exact))
for label, selector, device, make in cases:
    bt.config.set_rouse_kernel(selector)
    run, true = make()
    walls = []
    for _ in range(4 if device == "cuda" else 2):
        res, wall = timed(run, device)
        walls.append(wall)
    steps = sum(s.n_steps_host for s in res.samplers)
    out = {"tree": sys.argv[1], "case": label, "card": card, "walls_s": walls,
           "amis_steps": steps,
           "frame_accuracy": float(np.mean(np.asarray(res.best_profile()[:])
                                           == true)),
           "evidence": [float(x) for x in res.evidence]}
    if device == "cuda":
        copies = getattr(graphs.replay, "copies", None)
        dev_ms, traced, calls, _, kern = smoke.graph_profile(run)
        out.update(
            device_ms=dev_ms, traced_wall_s=traced, busy_share=dev_ms / 1e3 / traced,
            launch_calls_per_step=calls / steps,
            copies_per_step=(None if copies is None
                             else (graphs.replay.copies - copies) / steps),
            kernels={k: {"launches": n, "device_ms": ms,
                         "us_per_launch": ms * 1e3 / n}
                     for k, (n, ms) in kern.items()})
    print(json.dumps(out), flush=True)
