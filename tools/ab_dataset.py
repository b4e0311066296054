#!/usr/bin/env python3
"""
Config 3's lockstep `sample_dataset` walls for one checkout of the port,
four calls in one process under each kernel selector, on the GPU.

    python3 tools/ab_dataset.py TREE

``TREE`` is the root of a checkout (e.g. a `git archive` of another
commit unpacked into a git-ignored directory); its `bild_tpu_torch` and
`chip_smoke.py` are imported. The first call of a process pays the
kernel build (if the tree has none yet) and one-time warm-up; compare the
later calls. To compare two commits, run both in one call to the GPU in
the order A, B, B, A.
"""
import os
import subprocess
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bild_tpu_torch as bt  # noqa: E402
import chip_smoke  # noqa: E402
from bild_tpu_torch.parallel import sample_dataset  # noqa: E402

if not bt.__file__.startswith(tree):
    raise SystemExit(f"imported {bt.__file__}, not the tree {tree}")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True, text=True,
                     check=True).stdout.strip(), flush=True)
bt.config.exact_fp32()
model = bt.models.MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1,
                                  device="cuda")
truths = chip_smoke.truth_profiles(np.random.default_rng(3), 128, 100, 2)
batch = model.trajectories_from_loopingprofiles(
    truths, generator=torch.Generator(device="cuda").manual_seed(3))
trajs = [bt.Trajectory(data=batch.data[i], valid=batch.valid[i],
                       localization_error=np.full(3, 0.1)) for i in range(128)]
kw = dict(k_max=4, steps_per_k=12, N=128, informed_init=True, scout_steps=4,
          refine_top=3, marginals=True, optimize_boundaries=True, chunk_size=64)
for selector in ("sym", "dense"):
    bt.config.set_rouse_kernel(selector)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample_dataset(model, trajs, **kw, generator=torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"{sys.argv[1]} {selector} walls " + " ".join(f"{w:.3f}" for w in walls),
          flush=True)
