#!/usr/bin/env python3
"""
The float32 packed kernel (``csrc/kalman_sym.cu``, its covariance carried
in float64) under two launch bounds, on one GPU:

    python3 tools/sym_launch_bounds.py [--parent DIR]

(from the repository root). Builds two copies of the source into the
package's ``_build/`` (the package never loads them): as it stands, one
block per SM (``__launch_bounds__(256, 1)``), and held to two blocks per
SM (``__launch_bounds__(256, 2)``, at most 128 registers a thread), and
prints each copy's ``nvcc -Xptxas -v`` registers, stack frame and spills.
At the shapes of PERF.md's kernel table (``chip_smoke.PARENT_SHAPES``:
L=1, P=100; L=1, P=8192; L=640, P=128; config 4's scout, L=112, T=1000,
three states; L=5,120) it times each copy with 16- and 32-profile tiles
where the launch has enough lanes (else the planner's tile), the
package's dense kernel, and, with ``--parent DIR`` (a checkout of the
parent commit, e.g. a ``git archive`` under the git-ignored ``_chip/``),
the parent's two float32 kernels with their own plans (a float32
covariance), in turns (CUDA events, the mean of two timings). Then each
copy and the dense kernel in float32 against the package's float64 build
at ``chip_smoke.py``'s ladder rung T=1000 (three states): the max
relative error and the centered nats per profile family. Prints the
card's name and power limit first. Needs one CUDA device and nvcc;
imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bench_e2e_torch import THREE_STATES, truth_profiles  # noqa: E402

BOUND = "__launch_bounds__(kThreads, 1)"
MIN_BLOCKS = (1, 2)


def build(_build, min_blocks):
    """kalman_sym.cu with ``min_blocks`` in its launch bounds, loaded, and
    its ``-Xptxas -v`` lines."""
    src = (_build.CSRC / "kalman_sym.cu").read_text()
    if src.count(BOUND) != 1:
        raise SystemExit(f"no unique {BOUND!r} in kalman_sym.cu")
    tag = f"kalman_sym_min_blocks_{min_blocks}"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = _build.BUILD_DIR / f"{tag}.cu", _build.BUILD_DIR / f"{tag}.so"
    cu.write_text(src.replace(BOUND, f"__launch_bounds__(kThreads, {min_blocks})"))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(_build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {cu.name}:\n{proc.stderr}")
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "kalman_sym_kernelIf" in ln or "Used" in ln or "stack frame" in ln]
    lib = ctypes.CDLL(str(so))
    lib.bild_kalman_sym_f32.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 12
                                        + [ctypes.c_void_p])
    return lib, lines


def sym_launch(lib, model, args, tile, cov_itemsize):
    """``run() -> logL`` of kernel library ``lib`` at ``tile`` profiles a
    block (its layout from ``sym_smem_bytes``)."""
    from bild_tpu_torch.ops.kalman_sym import sym_smem_bytes

    s2, Cind, prof, ydata, valid = args
    ops = model.sym_operators()
    L, P, T = prof.shape
    n, N = model.Bs.shape[:2]
    smem = sym_smem_bytes(tile, n, N, 3, 1, 4, cov_itemsize=cov_itemsize)

    def run():
        out = torch.empty((L, P), device="cuda")
        rc = lib.bild_kalman_sym_f32(
            ops.Pslab.data_ptr(), ops.sig.data_ptr(), ops.c0.data_ptr(),
            model.w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
            ops.M0w.data_ptr(), s2.data_ptr(), Cind.data_ptr(), prof.data_ptr(),
            ydata.data_ptr(), valid.data_ptr(), out.data_ptr(), n, N, 3, 1, L, P,
            T, ops.PPp, ops.N1p, tile, smem, 0, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kalman_sym launch failed: {rc}")
        return out
    return run


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sym_launch_bounds.py: no CUDA device")
    import bild_tpu_torch as bt
    from bild_tpu_torch.ops import _build
    from bild_tpu_torch.ops.kalman_dense import (cind_tensor, dense_plan,
                                                 msrouse_logL_dense)
    from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym, sym_plan

    print(cs.card(), flush=True)
    bt.config.exact_fp32()
    libs = {}
    for mb in MIN_BLOCKS:
        libs[mb], lines = build(_build, mb)
        for ln in lines:
            print(f"min blocks {mb}: {ln}", flush=True)
    parent = ({name: cs.parent_entry(cs.build_parent(args.parent, name), name,
                                     torch.float32)
               for name in ("kalman_sym", "kalman_dense")} if args.parent else {})
    gen = torch.Generator(device="cuda").manual_seed(17)
    for label, L, P, T, n in cs.PARENT_SHAPES:
        loops = THREE_STATES if n == 3 else (None, (0, -1))
        model = bt.models.MultiStateRouse(20, 1.0, 5.0, d=3, looppositions=loops,
                                          localization_error=0.1, device="cuda",
                                          dtype=torch.float32)
        B = min(L, 128)
        data = model.trajectories_from_loopingprofiles(
            truth_profiles(np.random.default_rng(3), B, T, n),
            generator=torch.Generator(device="cuda").manual_seed(3)).data
        ydata = data[torch.arange(L, device="cuda") % B].contiguous()
        valid = torch.rand((L, T), generator=gen, device="cuda") > 0.05
        prof = cs.lane_profiles(gen, L, P, n, T)
        s2, Cind = model._noise_arrays(bt.Trajectory(ydata[0], valid[0]))
        Cind = cind_tensor(Cind, 3, ydata.device)
        launch = (s2, Cind, prof, ydata, valid)
        margs = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                 s2, Cind, prof, ydata, valid)
        tiles = sorted({16, 32} if L > 1 else {sym_plan(L, P, n, 20, 3, 1, 4).tile})
        runs = {f"sym, {mb} block(s) per SM, tile {t}": sym_launch(libs[mb], model, launch, t, 8)
                for mb in MIN_BLOCKS for t in tiles}
        runs["dense (package)"] = lambda: msrouse_logL_dense(*margs)
        if parent:
            sp = sym_plan(L, P, n, 20, 3, 1, 4, cov_itemsize=4)
            dp = dense_plan(L, P, n, 20, 3, 1, 4, cov_itemsize=4)
            stream = torch.cuda.current_stream().cuda_stream
            runs[f"parent sym, tile {sp.tile}"] = sym_launch(
                _ParentLib(parent["kalman_sym"]), model, launch, sp.tile, 4)

            def parent_dense():
                out = torch.empty((L, P), device="cuda")
                rc = parent["kalman_dense"](
                    *(x.data_ptr() for x in (model.Bs, model.Gs, model.Sigs, model.M0s,
                                             model.C0s, model.w, s2, Cind, prof, ydata,
                                             valid, out)),
                    n, 20, 3, 1, L, P, T, dp.warps, int(dp.ops_shared), dp.smem, 0, stream)
                if rc != 0:
                    raise RuntimeError(f"parent dense launch failed: {rc}")
                return out
            runs["parent dense"] = parent_dense
        ref = msrouse_logL_sym(*margs, ops=model.sym_operators(), matmul="exact")
        reps = max(1, min(20, int(2e4 // (L * P * T / 1e3))))
        first = {k: cs.time_ms(f, reps) for k, f in runs.items()}
        second = {k: cs.time_ms(f, reps) for k, f in reversed(list(runs.items()))}
        for k, f in runs.items():
            e = cs.rel_err(f().cpu().numpy(), ref.cpu().numpy())
            print(f"{label} L={L} P={P} T={T} n={n}: {k}: "
                  f"{(first[k] + second[k]) / 2:.3f} ms (rel to the package's sym "
                  f"{e:.1e})", flush=True)
    # the ladder's T=1000 rung: float32 against the float64 build
    models, traj, families, prof, fam_of = cs.ladder_case(bt, 1000, 3)
    prof_t = torch.as_tensor(prof, device="cuda")[None]
    ydata, valid = traj.data[None].contiguous(), traj.valid[None].contiguous()
    m32, m64 = models[torch.float32], models[torch.float64]
    s2, Cind = m32._noise_arrays(traj)
    Cind = cind_tensor(Cind, 3, ydata.device)
    s64, _ = m64._noise_arrays(traj)
    a64 = (m64.Bs, m64.Gs, m64.Sigs, m64.M0s, m64.C0s, m64.w, s64, Cind, prof_t,
           ydata.double(), valid)
    want = {"sym": msrouse_logL_sym(*a64, ops=m64.sym_operators()),
            "dense": msrouse_logL_dense(*a64)}
    a32 = (m32.Bs, m32.Gs, m32.Sigs, m32.M0s, m32.C0s, m32.w, s2, Cind, prof_t,
           ydata, valid)
    tile = sym_plan(1, len(prof), 3, 20, 3, 1, 4).tile
    got = {f"sym, {mb} block(s) per SM": ("sym", sym_launch(
        libs[mb], m32, (s2, Cind, prof_t, ydata, valid), tile, 8)()) for mb in MIN_BLOCKS}
    got["dense (package)"] = ("dense", msrouse_logL_dense(*a32))
    for k, (ref_name, g) in got.items():
        g = g.cpu().numpy()[0].astype(float)
        w = want[ref_name].cpu().numpy()[0]
        err = g - w
        cen = [cs.centered_nats(err[fam_of == i], fam_of[fam_of == i]) for i in range(3)]
        print(f"ladder T=1000 n=3, {k}: float32 against the float64 build: max rel "
              f"{np.max(np.abs(err / w)):.2e}, centered nats per family "
              f"{' / '.join(f'{c:.4f}' for c in cen)}", flush=True)


class _ParentLib:
    """The parent's typed sym entry point under the name `sym_launch` calls."""

    def __init__(self, fn):
        self.bild_kalman_sym_f32 = fn


if __name__ == "__main__":
    main()
