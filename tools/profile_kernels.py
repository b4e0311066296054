#!/usr/bin/env python3
"""
Where the time of the port's two CUDA likelihood kernels goes, on one GPU.

    python3 tools/profile_kernels.py        (from the repository root)

At config 3's lockstep launch (L=640 lanes x P=128 profiles, T=100, the
README model N=20, d=3, two states, float32):

1. Times both kernels (CUDA events, mean of 3 after a warm-up) with every
   frame observed, with no frame observed (no measurement update: the
   difference is the update's time), and, for the packed kernel, with every
   profile in one state (half the operator bytes streamed per tile-frame).
2. Builds ``csrc/kalman_sym.cu`` once more with its phase marks
   (``BILD_PHASE``) defined, into ``bild_tpu_torch/_build/`` (the package
   never loads it): thread 0 of every block adds the ``clock64()`` cycles
   since the last mark to the phase the mark ends. Runs it at the lockstep
   launch and at the single-trajectory step (L=1, P=100), and prints each
   phase's share of thread 0's cycles. Thread 0 takes part in every block
   barrier, so its cycles are the block's frame time; a phase that ends in
   a barrier includes the wait for the slowest thread. The counters cost
   registers, so the instrumented kernel reads a little slower.

Prints the card's name and power limit first. Needs one CUDA device and
nvcc; imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bild_tpu_torch as bt  # noqa: E402
from bild_tpu_torch.ops import _build, kalman_dense, kalman_sym  # noqa: E402

N, D, KSPRING, DIM, T = 20, 1.0, 5.0, 3, 100
PHASES = ("partition", "prologue + means", "slab wait + barrier",
          "issue next slab", "product (FMA)", "epilogue + barrier", "update")


def time_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# Defines the phase marks of csrc/kalman_sym.cu (empty in the package's
# build), then includes that source unchanged: thread 0 of every block sums
# the clock64() cycles of each phase, and of the whole frame loop in slot
# 7, into a device array that two added C functions zero and read.
PHASE_SOURCE = r"""
__device__ unsigned long long g_phase[8];
#define BILD_PHASE_START() \
  unsigned long long bild_ph[8] = {}; long long bild_tc = clock64(); const long long bild_t0 = bild_tc
#define BILD_PHASE(k) \
  do { const long long now_ = clock64(); bild_ph[k] += now_ - bild_tc; bild_tc = now_; } while (0)
#define BILD_PHASE_END() \
  do { bild_ph[7] = clock64() - bild_t0; \
       if (threadIdx.x == 0) for (int k_ = 0; k_ < 8; ++k_) atomicAdd(&g_phase[k_], bild_ph[k_]); } while (0)
#include "kalman_sym.cu"
extern "C" int bild_phase_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase)); }
extern "C" int bild_phase_zero() { unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }
"""


def build_instrumented() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "kalman_sym_phases.cu"
    so = _build.BUILD_DIR / "kalman_sym_phases.so"
    cu.write_text(PHASE_SOURCE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.bild_kalman_sym_f32.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 12
                                        + [ctypes.c_void_p])
    return lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    bt.config.exact_fp32()
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM, localization_error=0.1,
                                      device="cuda", dtype=torch.float32)
    ops = model.sym_operators()
    rng = np.random.default_rng(1)

    def launch_inputs(L, P):
        prof = torch.as_tensor(rng.integers(0, 2, size=(L, P, T)).astype(np.int32),
                               device="cuda")
        data = model.trajectories_from_loopingprofiles(
            rng.integers(0, 2, size=(L, T)),
            generator=torch.Generator(device="cuda").manual_seed(3)).data.contiguous()
        valid = torch.ones((L, T), dtype=torch.bool, device="cuda")
        s2, Cind = model._noise_arrays(bt.Trajectory(data[0], valid[0]))
        return prof, data, valid, s2, Cind

    L, P = 640, 128
    prof, data, valid, s2, Cind = launch_inputs(L, P)
    args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2, Cind)
    none = torch.zeros_like(valid)
    one_state = torch.zeros_like(prof)
    kernels = {"kalman_sym": lambda p, v: kalman_sym.msrouse_logL_sym(*args, p, data, v, ops=ops),
               "kalman_dense": lambda p, v: kalman_dense.msrouse_logL_dense(*args, p, data, v)}
    for name, kern in kernels.items():
        full = time_ms(lambda: kern(prof, valid))
        bare = time_ms(lambda: kern(prof, none))
        line = (f"{name:12s} L={L} P={P}: {full:.3f} ms; with no frame observed "
                f"{bare:.3f} ms (the update {full - bare:.3f} ms, {1 - bare / full:.1%})")
        if name == "kalman_sym":
            line += f"; every profile in one state {time_ms(lambda: kern(one_state, valid)):.3f} ms"
        print(line, flush=True)

    lib = build_instrumented()
    buf = (ctypes.c_ulonglong * 8)()
    for L, P in ((640, 128), (1, 100)):
        prof, data, valid, s2, Cind = launch_inputs(L, P)
        plan = kalman_sym.sym_plan(L, P, 2, N, DIM, 1, 4)
        out = torch.empty((L, P), device="cuda")
        cind = Cind.to(torch.int32).contiguous()

        def run():
            rc = lib.bild_kalman_sym_f32(
                ops.Pslab.data_ptr(), ops.sig.data_ptr(), ops.c0.data_ptr(),
                model.w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
                ops.M0w.data_ptr(), s2.data_ptr(), cind.data_ptr(), prof.data_ptr(),
                data.data_ptr(), valid.data_ptr(), out.data_ptr(), 2, N, DIM, 1, L, P, T,
                ops.PPp, ops.N1p, plan.tile, plan.smem, 0,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"instrumented launch failed: {rc}")

        run()
        torch.cuda.synchronize()
        lib.bild_phase_zero()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        lib.bild_phase_read(buf)
        per = buf[7] / plan.blocks / (T - 1)
        print(f"kalman_sym phases L={L} P={P} (tile {plan.tile}, {plan.blocks} blocks, "
              f"instrumented {ms:.3f} ms): {per:.0f} thread-0 cycles per block-frame",
              flush=True)
        for k, phase in enumerate(PHASES):
            print(f"    {phase:20s} {buf[k] / buf[7]:7.2%}", flush=True)


if __name__ == "__main__":
    main()
