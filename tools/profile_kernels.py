#!/usr/bin/env python3
"""
Where the time of the port's CUDA likelihood kernels goes, on one GPU.

    python3 tools/profile_kernels.py [--tree DIR] [--split-only]

(from the repository root). ``--tree`` profiles the checkout at DIR (for
example the parent commit unpacked by ``git archive`` under the
git-ignored ``_chip/``) instead of this one; ``--split-only`` skips the
exact tier and the dense kernel.

At config 3's lockstep launch (L=640 lanes x P=128 profiles, T=100, the
README model N=20, d=3, two states, float32):

1. Times the exact packed kernel and the dense kernel (CUDA events, mean
   of 3 after a warm-up) with every frame observed, with no frame observed
   (no measurement update: the difference is the update's time), and, for
   the packed kernel, with every profile in one state (half the operator
   bytes streamed per tile-frame).
2. Builds the packed kernel's exact tier (``csrc/kalman_sym.cu``) once
   more with its phase marks (``BILD_PHASE``) defined, into the package's
   ``_build/`` (the package never loads it): thread 0 of every block adds
   the ``clock64()`` cycles since the last mark to the phase the mark ends.
   Runs it at the lockstep launch and at the single-trajectory step (L=1,
   P=100), both on the tile plan, and prints each phase's share of thread
   0's cycles; then the cluster plan's kernel of the same source at the
   single-trajectory step (`CLUSTER_PHASES`; where the tree has it).
3. The same for the split-bf16 tiers ('split_cov', 'split'), built from
   ``csrc/kalman_sym_split.cu`` with its marks (`SPLIT_PHASES`), plus each
   tier's plain time at both launches. A tree from before that source
   existed (the split tiers inside ``csrc/kalman_sym.cu``, which has no
   marks in its split path) is instrumented by inserting the same phases'
   marks at the lines `PARENT_SPLIT_MARKS` names.

Thread 0 takes part in every barrier of the frame loop, so its cycles are
the block's frame time; a phase that ends in a barrier includes the wait
for the slowest thread. The counters cost registers, so the instrumented
kernel reads a little slower. Prints the card's name and power limit
first. Needs one CUDA device and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N, D, KSPRING, DIM, T = 20, 1.0, 5.0, 3, 100
PHASES = ("partition", "prologue + means", "slab wait + barrier",
          "issue next slab", "product (FMA)", "epilogue + barrier", "update")
CLUSTER_PHASES = ("states + data", "means", "product (FMA)",
                  "exchange (stores + barrier wait)", "update: Cw", "update: 1/S",
                  "update: downdate, means, logL")
SPLIT_PHASES = ("partition", "split c into bf16 pairs", "means",
                "conjugation (waits + mma)", "epilogue + barrier",
                "update contraction (Cw, S)", "downdate, mean update, logL")
# The split path of csrc/kalman_sym.cu before the split tiers had a source
# of their own: (line, the same line with SPLIT_PHASES' mark beside it).
PARENT_SPLIT_MARKS = (
    ("    // m-tiles per pass: at most a slab's",
     "    BILD_PHASE(1);\n    // m-tiles per pass: at most a slab's"),
    ("      if (mt0 == 0) propagate_means();\n      for (int ks = 0; ks < KS; ++ks) {",
     "      if (mt0 == 0) propagate_means();\n      BILD_PHASE(2);\n"
     "      for (int ks = 0; ks < KS; ++ks) {"),
    ("#pragma unroll\n      for (int j = 0; j < kItems; ++j) {\n"
     "        const int item = warp + j * nwarps;\n        if (item >= items) continue;",
     "      BILD_PHASE(3);\n#pragma unroll\n      for (int j = 0; j < kItems; ++j) {\n"
     "        const int item = warp + j * nwarps;\n        if (item >= items) continue;"),
    ("\n    }\n    __syncthreads();\n  };\n\n  prefetch(0);",
     "\n      BILD_PHASE(4);\n    }\n    __syncthreads();\n    BILD_PHASE(4);\n  };\n\n"
     "  prefetch(0);"),
    ("      Sinv[col] = scalar_t(1) / (((hh + hl) + lh) + s2[col % q]);\n    }\n"
     "    __syncthreads();\n",
     "      Sinv[col] = scalar_t(1) / (((hh + hl) + lh) + s2[col % q]);\n    }\n"
     "    __syncthreads();\n    BILD_PHASE(5);\n"),
    ("      Sinv[col] = scalar_t(1) / (dot(R + col * N, w, N) + s2[col % q]);\n"
     "    __syncthreads();\n",
     "      Sinv[col] = scalar_t(1) / (dot(R + col * N, w, N) + s2[col % q]);\n"
     "    __syncthreads();\n    BILD_PHASE(5);\n"),
)


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


# Defines the phase marks (empty in the package's build), then includes a
# kernel source unchanged: thread 0 of every block sums the clock64()
# cycles of each phase, and of the whole frame loop in slot 7, into a
# device array that two added C functions zero and read.
PHASE_SOURCE = r"""
__device__ unsigned long long g_phase[8];
#define BILD_PHASE_START() \
  unsigned long long bild_ph[8] = {}; long long bild_tc = clock64(); const long long bild_t0 = bild_tc
#define BILD_PHASE(k) \
  do { const long long now_ = clock64(); bild_ph[k] += now_ - bild_tc; bild_tc = now_; } while (0)
#define BILD_PHASE_END() \
  do { bild_ph[7] = clock64() - bild_t0; \
       if (threadIdx.x == 0) for (int k_ = 0; k_ < 8; ++k_) atomicAdd(&g_phase[k_], bild_ph[k_]); } while (0)
#include "%s"
extern "C" int bild_phase_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_phase, sizeof(g_phase)); }
extern "C" int bild_phase_zero() { unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }
"""


def build_instrumented(_build, source: Path, tag: str, symbols, n_ptr, n_int) -> ctypes.CDLL:
    """``source`` with its phase marks defined, as ``_build/<tag>.so``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{tag}.cu"
    so = _build.BUILD_DIR / f"{tag}.so"
    cu.write_text(PHASE_SOURCE % source.resolve())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the instrumented copy:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for sym in symbols:
        getattr(lib, sym).argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                                      + [ctypes.c_void_p])
    return lib


def split_source(_build) -> Path:
    """The split tiers' source, with phase marks: ``csrc/kalman_sym_split.cu``,
    or a tree's older ``csrc/kalman_sym.cu`` with `PARENT_SPLIT_MARKS`."""
    own = _build.CSRC / "kalman_sym_split.cu"
    if own.exists():
        return own
    text = (_build.CSRC / "kalman_sym.cu").read_text()
    for line, marked in PARENT_SPLIT_MARKS:
        if text.count(line) != 1:
            raise RuntimeError(f"no unique line to mark in kalman_sym.cu: {line!r}")
        text = text.replace(line, marked)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "kalman_sym_split_marked.cu"
    out.write_text(text)
    return out


def phase_run(lib, entry, ptrs, model, ops, L, P, tier, launch_inputs, kalman_sym, phases,
              force=None):
    """One instrumented launch at (L, P) with `sym_plan`'s plan (forced onto
    ``force`` where the tree's planner takes it): its time and each
    phase's share."""
    import inspect

    prof, data, valid, s2, Cind = launch_inputs(L, P)
    forcing = "_force" in inspect.signature(kalman_sym.sym_plan).parameters
    plan = kalman_sym.sym_plan(L, P, 2, N, DIM, 1, 4, tier=tier,
                               **({"_force": force} if forcing and force else {}))
    out = torch.empty((L, P), device="cuda")
    cind = Cind.to(torch.int32).contiguous()
    fn = getattr(lib, entry)
    # the split kernel's ring depth (not in the exact tier's, nor in the
    # older split kernel's, entry); the cluster kernel's cluster size
    if getattr(plan, "cluster", 0):
        stages = (plan.cluster,)
    else:
        stages = (plan.stages,) if len(fn.argtypes) - (len(ptrs) + 12) - 1 == 13 else ()

    def run():
        rc = fn(*ptrs, ops.sig.data_ptr(), ops.c0.data_ptr(),
                model.w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
                ops.M0w.data_ptr(), s2.data_ptr(), cind.data_ptr(), prof.data_ptr(),
                data.data_ptr(), valid.data_ptr(), out.data_ptr(), 2, N, DIM, 1, L, P, T,
                ops.PPp, ops.N1p, plan.tile, *stages, plan.smem, 0,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"instrumented launch failed: {rc}")

    buf = (ctypes.c_ulonglong * 8)()
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
    ring = (f", {stages[0]} {'per cluster' if getattr(plan, 'cluster', 0) else 'stages'}"
            if stages else "")
    print(f"{entry} phases L={L} P={P} (tile {plan.tile}, {plan.blocks} blocks, "
          f"{plan.smem} B shared{ring}, instrumented {ms:.3f} ms): "
          f"{per:.0f} thread-0 cycles per block-frame", flush=True)
    for k, phase in enumerate(phases):
        print(f"    {phase:28s} {buf[k] / buf[7]:7.2%}  {buf[k] / plan.blocks / (T - 1):9.0f} "
              f"cycles", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--split-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels.py: no CUDA device")
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import bild_tpu_torch as bt
    from bild_tpu_torch.ops import _build, kalman_dense, kalman_sym

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"profiling the tree at {Path(bt.__file__).resolve().parent.parent}", flush=True)
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

    if not args.split_only:
        L, P = 640, 128
        prof, data, valid, s2, Cind = launch_inputs(L, P)
        margs = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2, Cind)
        none = torch.zeros_like(valid)
        one_state = torch.zeros_like(prof)
        kernels = {"kalman_sym": lambda p, v: kalman_sym.msrouse_logL_sym(
                       *margs, p, data, v, ops=ops, matmul="exact"),
                   "kalman_dense": lambda p, v: kalman_dense.msrouse_logL_dense(
                       *margs, p, data, v)}
        for name, kern in kernels.items():
            full = time_ms(lambda: kern(prof, valid))
            bare = time_ms(lambda: kern(prof, none))
            line = (f"{name:12s} L={L} P={P}: {full:.3f} ms; with no frame observed "
                    f"{bare:.3f} ms (the update {full - bare:.3f} ms, {1 - bare / full:.1%})")
            if name == "kalman_sym":
                line += f"; every profile in one state {time_ms(lambda: kern(one_state, valid)):.3f} ms"
            print(line, flush=True)
        lib = build_instrumented(_build, _build.CSRC / "kalman_sym.cu", "kalman_sym_phases",
                                 ["bild_kalman_sym_f32"], 13, 12)
        for L, P in ((640, 128), (1, 100)):
            phase_run(lib, "bild_kalman_sym_f32", (ops.Pslab.data_ptr(),), model, ops,
                      L, P, "exact", launch_inputs, kalman_sym, PHASES, force="tile")
        if hasattr(lib, "bild_kalman_sym_cluster_f32"):
            lib.bild_kalman_sym_cluster_f32.argtypes = (
                [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
            phase_run(lib, "bild_kalman_sym_cluster_f32", (ops.Prow.data_ptr(),), model,
                      ops, 1, 100, "exact", launch_inputs, kalman_sym, CLUSTER_PHASES)

    entries = {"split_cov": "bild_kalman_sym_splitcov_f32", "split": "bild_kalman_sym_split_f32"}
    source = split_source(_build)
    lib = build_instrumented(_build, source, "kalman_sym_split_phases", entries.values(), 14,
                             13 if source.name == "kalman_sym_split.cu" else 12)
    for tier, entry in entries.items():
        for L, P in ((640, 128), (1, 100)):
            prof, data, valid, s2, Cind = launch_inputs(L, P)
            kern = lambda: kalman_sym.msrouse_logL_sym(  # noqa: E731
                model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2, Cind,
                prof, data, valid, ops=ops, matmul=tier)
            bare = torch.zeros_like(valid)
            full_ms = time_ms(kern)
            none_ms = time_ms(lambda: kalman_sym.msrouse_logL_sym(
                model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2, Cind,
                prof, data, bare, ops=ops, matmul=tier))
            print(f"{tier:9s} L={L} P={P}: package kernel {full_ms:.3f} ms; with no frame "
                  f"observed {none_ms:.3f} ms", flush=True)
            phase_run(lib, entry, (ops.Psplit.data_ptr(), ops.Srow.data_ptr()), model, ops,
                      L, P, tier, launch_inputs, kalman_sym, SPLIT_PHASES)


if __name__ == "__main__":
    main()
