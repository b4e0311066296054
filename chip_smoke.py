#!/usr/bin/env python3
"""
Drive bild_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          (from the repository root)

1. Builds the CUDA kernels of ``bild_tpu_torch/csrc/`` (into
   ``bild_tpu_torch/_build/``), one nvcc per source, all at once, and
   prints the build seconds.
2. Kernel phase: each kernel against its plain PyTorch version on the card
   (float32, rtol 2e-5 per profile) and against the float64 oracle
   (float32: rtol 2e-5; the kernels' float64 build: rtol 1e-9), at the
   shapes `sample()` gives them (P = 2, 198, 100; N=20, d=3, T=100) and at
   the edges of their contract (3 states, 3 distinct localization errors,
   missing frames, an unobserved first frame, out-of-range states -> NaN).
3. Timing phase: kernel and plain version at P = 100 and 8192 (CUDA events),
   beside the least time of the same work on the card (`kernel_work`: the
   likelihood's least FLOP and bytes, the same for both kernels; `bound_ms`:
   FLOP over the float32 peak or HBM bytes over its rate).
4. Slice phase: the README model, MultiStateRouse(N=20, D=1, k=5, d=3,
   localization_error=0.1), a T=100 trajectory with a loop at frames 30-60,
   and `bild_tpu_torch.sample()` with its defaults, once per kernel
   selector. The launch counters must show that the run went through the
   selected kernel and never through a plain version.
5. Lane phase: both kernels on one lane batch (L=6 trajectories with their
   own missing frames, P=37, T=100, out-of-range rows in two lanes), in
   float32 and float64, against the plain version, the f64 oracle and six
   single-lane launches of the same kernel (bit for bit).
6. Lockstep phase: both kernels against their plain versions and against
   their own float64 build at every lane shape the dataset run below
   launches (per 64-trajectory chunk: scout L=320, refine L=192, P=128;
   the boundary climb L=64, P=9) and at L=640, P=128 (config 3 in one
   chunk). There the profiles permuted within each lane must give the
   permuted results, and 7 profiles launched alone and three lanes
   launched alone (one profile per block) the same results, bit for bit
   (no tile or block shares anything between profiles), and both kernels
   are timed beside their bound.
7. Dataset phase (bench_e2e.py config 3): 128 trajectories of T=100 made by
   the port's batched generator, `parallel.sample_dataset` with informed
   init, the scout/refine schedule, marginals, the boundary climb and chunk
   checkpoints, once per kernel selector: accuracy against the truths, the
   launch counters, a rerun that loads both chunks, the device-busy share
   under torch.profiler, and the per-k checkpointed `sample_batch` equal to
   the all-k one on a 16-trajectory chunk.
8. Range phase: the dense kernel at the largest chains one warp takes
   (float32 N=168 at q=1 and N=120 at q=3, float64 N=116), its operators
   then in global memory, against its plain version or the f64 oracle.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as the last line ``{"ok": true, "device": {...}}``. Any
failed check raises: the exit code is then non-zero and no result is
printed. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

RTOL_F32 = 2e-5
RTOL_F64 = 1e-9
# NVIDIA H100 SXM peaks (data sheet, at the 700 W power limit): float32
# outside the tensor cores (the kernels use none: TF32 is off), HBM3
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12
SLICE_ACCURACY = 0.9
# the dataset phase's bars; bild_tpu's own run of this configuration
# recorded 0.993 and 0.852 (PERF_r04.json)
DATASET_FRAME_ACCURACY = 0.97
DATASET_SWITCH_ACCURACY = 0.75
N, D, KSPRING, DIM, T = 20, 1.0, 5.0, 3, 100
DEVICE = "cuda"


def kernel_work(L, P, T, n, N, d, q, observed):
    """``(FLOP, HBM bytes)`` that one float32 evaluation of the likelihood
    needs on these inputs, whichever kernel computes it: the least work of
    the direct recursion, C' and the downdate symmetric. ``observed``
    (lane, frame) pairs of the (L, T) mask take the measurement update,
    every profile propagates T-1 frames. Propagation, per profile-frame:
    per copy ``X = B C`` in full, ``2 N^3``, and ``C' = X B + Sig`` on the
    upper triangle, ``N (N+1) (2N+1) / 2``; the means ``d N (2N+1)``.
    Update: per copy ``Cw = C w`` (``2 N^2``), ``w.Cw`` (``2N``) and the
    downdate on the upper triangle (``N (N+1) + N``); ``w.M`` (``2 N d``),
    the mean update (``3 N d``) and the log-likelihood (``8 d``). Bytes:
    profiles, data, mask and results once, and the model's ``B, Sig, C0,
    G, M0, w`` once."""
    prop = q * (2 * N ** 3 + N * (N + 1) * (2 * N + 1) // 2) + d * N * (2 * N + 1)
    upd = q * (3 * N * N + 4 * N) + 5 * N * d + 8 * d
    ops = 3 * n * N * N + 2 * n * N * d + N
    flops = L * P * (T - 1) * prop + P * observed * upd
    nbytes = 4 * (L * P * T + L * T * d + L * P + ops) + L * T
    return flops, nbytes


def algorithm_flops(name, L, P, T, N, d, q, observed):
    """FLOP that kernel ``name``'s own algorithm spends on the same inputs,
    padding left out, as `kernel_work` counts them. Propagation: sym
    ``q (2 PP^2 + PP)`` (the packed operator, PP = N(N+1)/2) and the means
    ``d (N+1) (2N+1)`` (with the w.M row); dense ``q (4 N^3 + N^2)`` (both
    products in full) and ``d N (2N+1)``. Update: sym ``q (2 N^2 + 2N + 3
    PP)``, dense ``q (4 N^2 + 3N)`` (the full downdate), both plus ``5 N d
    + 8 d``."""
    PP = N * (N + 1) // 2
    if name == "kalman_sym":
        prop = q * (2 * PP * PP + PP) + d * (N + 1) * (2 * N + 1)
        upd = q * (2 * N * N + 2 * N + 3 * PP)
    else:
        prop = q * (4 * N ** 3 + N * N) + d * N * (2 * N + 1)
        upd = q * (4 * N * N + 3 * N)
    return L * P * (T - 1) * prop + P * observed * (upd + 5 * N * d + 8 * d)


def bound_ms(flops, nbytes):
    """The least time of that work on the card and what sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got, want):
    """Largest per-profile relative error over the finite reference rows."""
    fin = np.isfinite(want)
    return float(np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])))


def make_profiles(rng, P, n, T):
    """Half piecewise-constant profiles with up to 6 switches, half i.i.d."""
    prof = rng.integers(0, n, size=(P, T))
    for p in range(0, P, 2):
        cuts = np.sort(rng.choice(np.arange(1, T), size=rng.integers(0, 7),
                                  replace=False))
        states = rng.integers(0, n, size=len(cuts) + 1)
        prof[p] = states[np.searchsorted(cuts, np.arange(T), side="right")]
    return prof.astype(np.int32)


def kernel_cases():
    """(label, looppositions, localization_error, P, missing frames,
    out-of-range rows) at the README model's width."""
    two = (None, (0, -1))
    three = (None, (0, -1), (0, 10))
    return [
        ("k=0 exhaustive P=2", two, 0.1, 2, (), ()),
        ("k=1 exhaustive P=198", two, 0.1, 198, (), ()),
        ("AMIS step P=100, missing frames incl. t=0", two, 0.1, 100, (0, 7, 50), ()),
        ("3 states, q=3, P=100", three, (0.1, 0.2, 0.15), 100, (5, 60), ()),
        ("q=2, out-of-range rows, P=37", two, (0.1, 0.1, 0.3), 37, (99,), (3, 11)),
    ]


def kernel_phase(bt, rng):
    from bild_tpu_torch.ops.kalman_dense import (msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch)
    from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

    max_abs = {"kalman_sym": 0.0, "kalman_dense": 0.0}
    for label, loops, err, P, missing, bad_rows in kernel_cases():
        n = len(loops)
        for dtype in (torch.float32, torch.float64):
            model = bt.models.MultiStateRouse(
                N, D, KSPRING, d=DIM, looppositions=loops,
                localization_error=err, device=DEVICE, dtype=dtype)
            true = np.zeros(T, dtype=int)
            true[30:60] = 1
            traj = model.trajectory_from_loopingprofile(
                true, missing_frames=np.asarray(missing, dtype=int),
                generator=torch.Generator(device=DEVICE).manual_seed(P))
            prof = make_profiles(rng, P, n, T)
            for r, bad in zip(bad_rows, (n, -1)):
                prof[r, T // 2] = bad
            s2, Cind = model._noise_arrays(traj)
            args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                    model.w, s2, Cind, torch.as_tensor(prof, device=DEVICE),
                    traj.data, traj.valid)
            sym = msrouse_logL_sym(*args, ops=model.sym_operators())
            dense = msrouse_logL_dense(*args)
            torch.cuda.synchronize()
            sym, dense = sym.cpu().numpy(), dense.cpu().numpy()
            h = model.host
            oracle_rows = [p for p in range(P) if p not in bad_rows][:6]
            oracle = np.array([msrouse_logL_numpy(
                h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"],
                np.asarray(model._get_noise(traj)), prof[p], traj[:])
                for p in oracle_rows])
            nan_rows = np.zeros(P, dtype=bool)
            nan_rows[list(bad_rows)] = True
            for name, got in (("kalman_sym", sym), ("kalman_dense", dense)):
                check(np.array_equal(np.isnan(got), nan_rows),
                      f"{name} {label}: NaN exactly on out-of-range rows")
                check(np.all(np.isfinite(got[~nan_rows])),
                      f"{name} {label}: finite in-range rows")
                e_orc = rel_err(got[oracle_rows], oracle)
                line = f"{name:12s} {str(dtype)[6:]:7s} {label:42s} oracle rel {e_orc:.2e}"
                if dtype == torch.float32:
                    plain = (msrouse_logL_sym_torch(model.sym_operators(), *args[6:])
                             if name == "kalman_sym"
                             else msrouse_logL_dense_torch(*args)).cpu().numpy()
                    e_plain = rel_err(got, plain)
                    fin = ~nan_rows
                    max_abs[name] = max(max_abs[name], float(
                        np.max(np.abs(got[fin] - plain[fin]))))
                    line += f"  plain rel {e_plain:.2e}"
                    check(e_plain <= RTOL_F32, f"{line}: plain within {RTOL_F32}")
                    check(e_orc <= RTOL_F32, f"{line}: oracle within {RTOL_F32}")
                else:
                    check(e_orc <= RTOL_F64, f"{line}: oracle within {RTOL_F64}")
                print(line, flush=True)
    return max_abs


def counters():
    """Every kernel's launch counter and every plain version's call
    counter, as (function, attribute) by name."""
    from bild_tpu_torch.ops import kalman, kalman_dense, kalman_sym
    return {
        "kalman_sym": (kalman_sym.msrouse_logL_sym, "launches"),
        "kalman_dense": (kalman_dense.msrouse_logL_dense, "launches"),
        "plain_sym": (kalman_sym.msrouse_logL_sym_torch, "calls"),
        "plain_dense": (kalman_dense.msrouse_logL_dense_torch, "calls"),
        "plain_torch": (kalman.msrouse_logL_batch, "calls"),
    }


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def lane_kernel_phase(bt, rng, max_abs):
    """Both kernels on one (L=6, P=37, T=100) lane batch: per lane its own
    trajectory and missing frames (lane 1 misses its first frame), and
    out-of-range rows in lanes 1 and 4. Each launch is held against its
    plain version, the f64 oracle on two rows per lane, and six single-lane
    launches of the same kernel, which must agree bit for bit."""
    from bild_tpu_torch.ops.kalman_dense import (msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch)
    from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

    L, P = 6, 37
    bad = {(1, 3): 2, (4, 11): -1}
    prof = np.stack([make_profiles(rng, P, 2, T) for _ in range(L)])
    for (lane, row), state in bad.items():
        prof[lane, row, T // 2] = state
    nan_rows = np.zeros((L, P), dtype=bool)
    for lane, row in bad:
        nan_rows[lane, row] = True
    valid = np.ones((L, T), dtype=bool)
    valid[1, 0] = False
    for lane in range(2, L):
        valid[lane, rng.choice(T, size=3 * lane, replace=False)] = False
    for dtype, rtol in ((torch.float32, RTOL_F32), (torch.float64, RTOL_F64)):
        model = bt.models.MultiStateRouse(
            N, D, KSPRING, d=DIM, localization_error=(0.1, 0.2, 0.1),
            device=DEVICE, dtype=dtype)
        batch = model.trajectories_from_loopingprofiles(
            make_profiles(rng, L, 2, T),
            generator=torch.Generator(device=DEVICE).manual_seed(11))
        valid_t = torch.as_tensor(valid, device=DEVICE)
        ydata = torch.where(valid_t[..., None], batch.data, 0.0).contiguous()
        prof_t = torch.as_tensor(prof, device=DEVICE)
        s2, Cind = model._noise_arrays(bt.Trajectory(ydata[0], valid_t[0]))
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                model.w, s2, Cind)
        ops = model.sym_operators()
        kernels = {
            "kalman_sym": (lambda *a: msrouse_logL_sym(*args, *a, ops=ops),
                           lambda *a: msrouse_logL_sym_torch(ops, s2, Cind, *a)),
            "kalman_dense": (lambda *a: msrouse_logL_dense(*args, *a),
                             lambda *a: msrouse_logL_dense_torch(*args, *a)),
        }
        h = model.host
        data_nan = np.where(valid[..., None], ydata.cpu().numpy(), np.nan)
        for name, (kern, plain) in kernels.items():
            got = kern(prof_t, ydata, valid_t)
            singles = [kern(prof_t[i], ydata[i], valid_t[i]) for i in range(L)]
            want = plain(prof_t, ydata, valid_t)
            torch.cuda.synchronize()
            got, want = got.cpu().numpy(), want.cpu().numpy()
            label = f"{name:12s} {str(dtype)[6:]:7s} lanes L={L} P={P}"
            check(got.shape == (L, P), f"{label}: result shape {got.shape}")
            check(np.array_equal(np.isnan(got), nan_rows),
                  f"{label}: NaN exactly on the out-of-range rows")
            check(all(np.array_equal(one.cpu().numpy(), got[i], equal_nan=True)
                      for i, one in enumerate(singles)),
                  f"{label}: single-lane launches equal the lane launch bit for bit")
            e_plain = rel_err(got, want)
            orc_err = 0.0
            for lane in range(L):
                rows = [r for r in range(P) if not nan_rows[lane, r]][:2]
                orc = np.array([msrouse_logL_numpy(
                    h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"],
                    np.array([0.1, 0.2, 0.1]), prof[lane, r], data_nan[lane])
                    for r in rows])
                orc_err = max(orc_err, rel_err(got[lane, rows], orc))
            line = f"{label}  plain rel {e_plain:.2e}  oracle rel {orc_err:.2e}"
            check(e_plain <= rtol, f"{line}: plain within {rtol}")
            check(orc_err <= rtol, f"{line}: oracle within {rtol}")
            if dtype == torch.float32:
                fin = ~nan_rows
                max_abs[name] = max(max_abs[name], float(
                    np.max(np.abs(got[fin] - want[fin]))))
            print(line, flush=True)


# (label, lanes, profiles per lane, trajectories the lanes cycle over): the
# launches of the dataset phase. Per 64-trajectory chunk the scout steps
# run 5 k x 64 lanes and the refine steps 3 x 64, 128 proposals each; the
# boundary climb scores 2 Kb + 1 = 9 candidates (Kb = k_max = 4) of each
# of up to 64 trajectories. The last shape is config 3 in one chunk.
LOCKSTEP_SHAPES = (
    ("chunk scout", 320, 128, 64),
    ("chunk refine", 192, 128, 64),
    ("boundary climb", 64, 9, 64),
    ("one chunk of 128", 640, 128, 128),
)


def lockstep_phase(bt, rng, max_abs):
    """Both kernels at every shape of `LOCKSTEP_SHAPES` (the dataset phase's
    trajectories, each lane with its own missing frames, out-of-range rows
    in the first and the last lane): against their plain versions and
    against their own float64 build on the same data (float32, rtol 2e-5
    per profile; NaN exactly on the out-of-range rows). At the largest
    shape: profiles permuted within each lane give the permuted results,
    and 7 chosen profiles launched alone and three lanes launched alone
    (one profile per block) give the same bits as in the full launch, so a
    tile or a block shares nothing between profiles; and both
    kernels are timed, in the order plain, kernel, kernel, plain.
    Returns ``{name: (ms, plain_ms, bound_ms)}`` at the largest shape."""
    from bild_tpu_torch.ops.kalman_dense import (msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch)

    L_max = max(s[1] for s in LOCKSTEP_SHAPES)
    P_max = max(s[2] for s in LOCKSTEP_SHAPES)
    truths = truth_profiles(np.random.default_rng(3), 128, T, 2)
    profs = np.stack([make_profiles(rng, P_max, 2, T) for _ in range(L_max)])
    valid_all = rng.random((L_max, T)) > 0.05
    kernels, data = {}, {}
    for dtype in (torch.float32, torch.float64):
        model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                          localization_error=0.1,
                                          device=DEVICE, dtype=dtype)
        if dtype == torch.float32:
            data = model.trajectories_from_loopingprofiles(
                truths, generator=torch.Generator(device=DEVICE).manual_seed(3)).data
        ops = model.sym_operators()
        s2, Cind = model._noise_arrays(bt.Trajectory(data[0], valid_all[0]))
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                model.w, s2, Cind)
        kernels[dtype] = {
            "kalman_sym": (
                lambda *a, args=args, ops=ops: msrouse_logL_sym(*args, *a, ops=ops),
                lambda *a, ops=ops, s2=s2, Cind=Cind: msrouse_logL_sym_torch(ops, s2, Cind, *a)),
            "kalman_dense": (
                lambda *a, args=args: msrouse_logL_dense(*args, *a),
                lambda *a, args=args: msrouse_logL_dense_torch(*args, *a)),
        }
    times = {}
    for label, L, P, B in LOCKSTEP_SHAPES:
        rows = torch.arange(L, device=DEVICE) % B
        valid = torch.as_tensor(valid_all[:L], device=DEVICE)
        ydata = data[rows].contiguous()
        ydata64 = ydata.double()
        prof = profs[:L, :P].copy()
        prof[0, P // 2, T // 3] = 2
        prof[L - 1, P - 1, T - 1] = -1
        nan_rows = np.zeros((L, P), dtype=bool)
        nan_rows[0, P // 2] = nan_rows[L - 1, P - 1] = True
        prof = torch.as_tensor(prof, device=DEVICE)
        for name in ("kalman_sym", "kalman_dense"):
            kern, plain = kernels[torch.float32][name]
            kern64 = kernels[torch.float64][name][0]
            got = kern(prof, ydata, valid)
            want = plain(prof, ydata, valid)
            got64 = kern64(prof, ydata64, valid)
            torch.cuda.synchronize()
            got, want, got64 = (x.cpu().numpy() for x in (got, want, got64))
            line = f"{name:12s} lockstep {label:17s} L={L:3d} P={P:3d}"
            check(got.shape == (L, P), f"{line}: result shape {got.shape}")
            check(np.array_equal(np.isnan(got), np.isnan(want))
                  and np.array_equal(np.isnan(got), np.isnan(got64))
                  and np.array_equal(np.isnan(got), nan_rows),
                  f"{line}: NaN exactly on the out-of-range rows, as the "
                  "plain version and the float64 build")
            e_plain, e_f64 = rel_err(got, want), rel_err(got, got64)
            line += f"  plain rel {e_plain:.2e}  f64 build rel {e_f64:.2e}"
            check(e_plain <= RTOL_F32, f"{line}: plain within {RTOL_F32}")
            check(e_f64 <= RTOL_F32, f"{line}: f64 build within {RTOL_F32}")
            fin = ~nan_rows
            max_abs[name] = max(max_abs[name], float(
                np.max(np.abs(got[fin] - want[fin]))))
            if L == L_max and P == P_max:
                perm = torch.stack([torch.randperm(P, generator=torch.Generator().manual_seed(i))
                                    for i in range(L)]).to(DEVICE)
                permuted = kern(torch.gather(prof, 1, perm[..., None].expand(-1, -1, T))
                                .contiguous(), ydata, valid)
                chosen = torch.as_tensor([0, 5, 17, P // 2, 90, P - 2, P - 1], device=DEVICE)
                alone = kern(prof[:, chosen].contiguous(), ydata, valid)
                lanes = (0, L // 2, L - 1)
                singles = [kern(prof[i], ydata[i], valid[i]) for i in lanes]
                torch.cuda.synchronize()
                same_perm = np.array_equal(permuted.cpu().numpy(),
                                           np.take_along_axis(got, perm.cpu().numpy(), 1),
                                           equal_nan=True)
                same_alone = np.array_equal(alone.cpu().numpy(),
                                            got[:, chosen.cpu().numpy()], equal_nan=True)
                same_single = all(np.array_equal(one.cpu().numpy(), got[i], equal_nan=True)
                                  for i, one in zip(lanes, singles))
                line += (f"  permuted within lanes: {'same bits' if same_perm else 'DIFFER'}"
                         f"  7 profiles alone: {'same bits' if same_alone else 'DIFFER'}"
                         f"  lanes alone: {'same bits' if same_single else 'DIFFER'}")
                check(same_perm, f"{line}: permuting profiles permutes the results bit for bit")
                check(same_alone, f"{line}: a subset of profiles gives the same bits")
                check(same_single, f"{line}: a lane launched alone (narrower tiles) "
                      "gives the same bits")
            print(line, flush=True)
            if L == L_max and P == P_max:
                p1 = time_ms(lambda: plain(prof, ydata, valid), 1)
                k1, k2 = (time_ms(lambda: kern(prof, ydata, valid), 2)
                          for _ in range(2))
                p2 = time_ms(lambda: plain(prof, ydata, valid), 1)
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                observed = int(valid.sum())
                flops, nbytes = kernel_work(L, P, T, 2, N, DIM, 1, observed)
                bnd, by = bound_ms(flops, nbytes)
                own = algorithm_flops(name, L, P, T, N, DIM, 1, observed)
                times[name] = (ms, plain_ms, bnd)
                print(f"time {name:12s} lockstep L={L} P={P}  kernel "
                      f"{ms:9.3f} ms ({L * P / ms * 1e3:12.1f} profiles/s)  "
                      f"plain {plain_ms:9.3f} ms "
                      f"({L * P / plain_ms * 1e3:12.1f} profiles/s)  bound "
                      f"{bnd:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP, "
                      f"{nbytes / 1e6:.1f} MB), {bnd / ms:.1%} of bound; its "
                      f"own algorithm {own / 1e9:.1f} GFLOP, "
                      f"{own / ms / 1e9:.2f} TFLOP/s", flush=True)
    return times


# the largest chains the dense kernel takes, its operators then in global
# memory (ops/kalman_dense.py::dense_plan): (N, localization errors, dtype)
RANGE_CASES = ((168, 0.1, torch.float32), (120, (0.1, 0.2, 0.15), torch.float32),
               (116, 0.1, torch.float64))


def range_phase(bt, rng):
    """The dense kernel at the largest N one warp takes (8 profiles, T=100,
    README-like model otherwise): float32 against its plain version (rtol
    2e-5), float64 against the f64 oracle on two profiles (rtol 1e-9), and
    both timed once beside the plain version."""
    from bild_tpu_torch.ops.kalman_dense import (dense_plan, msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

    P = 8
    for n_mono, err, dtype in RANGE_CASES:
        model = bt.models.MultiStateRouse(n_mono, D, KSPRING, d=DIM,
                                          localization_error=err,
                                          device=DEVICE, dtype=dtype)
        true = np.zeros(T, dtype=int)
        true[30:60] = 1
        traj = model.trajectory_from_loopingprofile(
            true, generator=torch.Generator(device=DEVICE).manual_seed(n_mono))
        prof = make_profiles(rng, P, 2, T)
        s2, Cind = model._noise_arrays(traj)
        plan = dense_plan(1, P, 2, n_mono, DIM, s2.shape[0], model.Bs.element_size())
        label = f"kalman_dense range N={n_mono} q={s2.shape[0]} {str(dtype)[6:]}"
        check(not plan.ops_shared, f"{label}: operators in global memory")
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                s2, Cind, torch.as_tensor(prof, device=DEVICE), traj.data, traj.valid)
        got = msrouse_logL_dense(*args)
        want = msrouse_logL_dense_torch(*args)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        check(np.all(np.isfinite(got)), f"{label}: finite")
        e_plain = rel_err(got, want)
        line = f"{label} ({plan.smem} B shared)  plain rel {e_plain:.2e}"
        if dtype == torch.float32:
            check(e_plain <= RTOL_F32, f"{line}: plain within {RTOL_F32}")
        else:
            h = model.host
            orc = np.array([msrouse_logL_numpy(
                h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"],
                np.asarray(model._get_noise(traj)), prof[p], traj[:]) for p in (0, 1)])
            e_orc = rel_err(got[:2], orc)
            line += f"  oracle rel {e_orc:.2e}"
            check(e_orc <= RTOL_F64, f"{line}: oracle within {RTOL_F64}")
        ms = time_ms(lambda: msrouse_logL_dense(*args), 1)
        plain_ms = time_ms(lambda: msrouse_logL_dense_torch(*args), 1)
        print(f"{line}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)


def truth_profiles(rng, B, T, n_states, k_max=4):
    """Random piecewise-constant truth profiles with 0..k_max switches (as
    bench_e2e.py's, which imports JAX and so is not imported here)."""
    profs = np.zeros((B, T), dtype=int)
    for b in range(B):
        k = int(rng.integers(0, k_max + 1))
        cuts = np.sort(rng.choice(np.arange(1, T), size=k, replace=False))
        bounds = np.concatenate([[0], cuts, [T]])
        s = int(rng.integers(0, n_states))
        for i in range(k + 1):
            profs[b, bounds[i]:bounds[i + 1]] = s
            choices = [c for c in range(n_states) if c != s]
            s = int(rng.choice(choices))
    return profs


def device_time_by_name(prof):
    """``{name: (ms, count)}`` of the device's events (kernels, copies) in
    a torch.profiler trace; empty if the trace holds none."""
    out = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, cnt = out.get(evt.name, (0.0, 0))
            out[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, cnt + 1)
    return out


def dataset_phase(bt, B=128, chunk_size=64, sub_B=16):
    """bench_e2e.py config 3 through `parallel.sample_dataset`, once per
    kernel selector (see the module docstring)."""
    from bild_tpu_torch.parallel import (TrajectoryBatch, sample_batch,
                                         sample_dataset)
    from bild_tpu_torch.parallel.batch import run_lanes
    from bild_tpu_torch.postproc import optimize_boundary_batch

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    truths = truth_profiles(np.random.default_rng(3), B, T, 2)
    true_k = np.sum(truths[:, 1:] != truths[:, :-1], axis=1)
    batch = model.trajectories_from_loopingprofiles(
        truths, generator=torch.Generator(device=DEVICE).manual_seed(3))
    trajs = [bt.Trajectory(data=batch.data[i], valid=batch.valid[i],
                           localization_error=np.full(DIM, 0.1))
             for i in range(B)]
    kw = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
              scout_steps=4, refine_top=3, marginals=True,
              optimize_boundaries=True, chunk_size=chunk_size)
    n_chunks = -(-B // chunk_size)
    out = {}
    for selector in ("sym", "dense"):
        bt.config.set_rouse_kernel(selector)
        with tempfile.TemporaryDirectory() as ck:
            def run():
                return sample_dataset(model, trajs, **kw, checkpoint_dir=ck,
                                      generator=torch.Generator().manual_seed(7))

            reset_counts()
            run_lanes.steps = run_lanes.lane_steps = 0
            optimize_boundary_batch.evaluations = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = read_counts()
            evals = run_lanes.lane_steps * kw["N"] + optimize_boundary_batch.evaluations
            steps, lane_steps = run_lanes.steps, run_lanes.lane_steps
            check(len(os.listdir(ck)) == n_chunks, f"{n_chunks} chunk files written")
            reset_counts()
            again = run()
            reloaded = read_counts()
        acc = float(np.mean(np.concatenate(res.best_profile()) == truths.ravel()))
        sw = float(np.mean(res.best_k() == true_k))
        acc_opt = float(np.mean(np.concatenate(res.optimized) == truths.ravel()))
        print(f"dataset selector={selector}: wall {wall:.3f} s, "
              f"{B / wall:.2f} trajectories/s, {evals / wall:.1f} profile "
              f"evaluations/s ({evals} evaluations), lockstep AMIS steps "
              f"{steps} ({lane_steps} lane-steps), frame accuracy {acc:.4f}, "
              f"switch-count accuracy {sw:.4f}, after the boundary climb "
              f"{acc_opt:.4f} ({int(res.eliminated.sum())} eliminated), "
              f"launches {ran}", flush=True)
        check(ran[f"kalman_{selector}"] > 0, f"{selector} kernel launched")
        check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
              "no plain version ran on the CUDA path")
        check(acc >= DATASET_FRAME_ACCURACY,
              f"frame accuracy {acc:.4f} >= {DATASET_FRAME_ACCURACY}")
        check(sw >= DATASET_SWITCH_ACCURACY,
              f"switch-count accuracy {sw:.4f} >= {DATASET_SWITCH_ACCURACY}")
        check(np.all(np.isfinite(res.evidence)), "every evidence finite (k < T)")
        check(res.mom_ok.all(), "CFC fixed point converged in every lane")
        check(all(np.allclose(np.exp(m).sum(axis=1), 1.0, rtol=1e-4)
                  for m in res.marginals), "marginals normalized")
        check(all(v == 0 for v in reloaded.values()),
              f"rerun loaded both chunks, launched nothing: {reloaded}")
        check(np.array_equal(again.evidence, res.evidence)
              and all(np.array_equal(a, b) for a, b in zip(
                  again.profiles_by_k + again.marginals + again.optimized,
                  res.profiles_by_k + res.marginals + res.optimized)),
              "rerun from the chunk checkpoints returns identical arrays")

        # device-busy share of one more run, traced
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sample_dataset(model, trajs, **kw,
                           generator=torch.Generator().manual_seed(7))
            torch.cuda.synchronize()
            wall_p = time.perf_counter() - t0
        by_name = device_time_by_name(prof)
        busy = sum(ms for ms, _ in by_name.values())
        share = (f"{busy / 1e3 / wall_p:.4f} ({busy:.1f} ms of {wall_p:.3f} s "
                 f"profiled wall, {sum(c for _, c in by_name.values())} device "
                 "events)" if busy > 0 else "not measured (no device events "
                 "in the trace)")
        print(f"dataset selector={selector}: device busy share {share}",
              flush=True)
        for name, (ms, cnt) in sorted(by_name.items(),
                                      key=lambda kv: -kv[1][0])[:5]:
            print(f"    {ms:10.1f} ms {cnt:7d}x  {name[:90]}", flush=True)

        # the per-k checkpointed schedule equals the all-k one
        sub = TrajectoryBatch(data=batch.data[:sub_B], valid=batch.valid[:sub_B],
                              lengths=np.full(sub_B, T))
        bk = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
                  marginals=True)
        fused = sample_batch(model, sub, **bk,
                             generator=torch.Generator().manual_seed(9))
        with tempfile.TemporaryDirectory() as d:
            per_k = sample_batch(model, sub, **bk,
                                 checkpoint=os.path.join(d, "ck.npz"),
                                 generator=torch.Generator().manual_seed(9))
        same = all(np.array_equal(getattr(fused, f), getattr(per_k, f))
                   for f in ("evidence", "evidence_se", "map_profiles",
                             "marginals", "mom_ok"))
        print(f"dataset selector={selector}: per-k checkpointed sample_batch "
              f"on {sub_B} trajectories equals the all-k one: {same}",
              flush=True)
        check(same, "per-k checkpoint path equals the fused path")
        out[selector] = ran
    bt.config.set_rouse_kernel("sym")
    return out


def time_ms(fn, reps):
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


def timing_phase(bt, rng):
    """Kernel and plain version at the AMIS step (P=100) and at the bench
    shape (P=8192), in the order plain, kernel, kernel, plain, beside the
    bound computed from the same inputs. Returns ``{(name, P): (ms,
    plain_ms, bound_ms, bound_by)}``."""
    from bild_tpu_torch.ops.kalman_dense import (msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch)

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    true = np.zeros(T, dtype=int)
    true[30:60] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator(device=DEVICE).manual_seed(1))
    s2, Cind = model._noise_arrays(traj)
    ops = model.sym_operators()
    times = {}
    for P, reps in ((100, 20), (8192, 3)):
        prof = torch.as_tensor(make_profiles(rng, P, 2, T), device=DEVICE)
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                model.w, s2, Cind, prof, traj.data, traj.valid)
        fns = {
            "kalman_sym": (lambda: msrouse_logL_sym(*args, ops=ops),
                           lambda: msrouse_logL_sym_torch(ops, *args[6:])),
            "kalman_dense": (lambda: msrouse_logL_dense(*args),
                             lambda: msrouse_logL_dense_torch(*args)),
        }
        for name, (kern, plain) in fns.items():
            p1, k1, k2, p2 = (time_ms(f, reps) for f in (plain, kern, kern, plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            bnd, by = bound_ms(*kernel_work(1, P, T, 2, N, DIM, 1,
                                            int(traj.valid.sum())))
            times[(name, P)] = (ms, plain_ms, bnd, by)
            print(f"time {name:12s} P={P:5d}  kernel {ms:9.3f} ms "
                  f"({P / ms * 1e3:12.1f} profiles/s)  plain {plain_ms:9.3f} ms "
                  f"({P / plain_ms * 1e3:12.1f} profiles/s)  bound {bnd:.4f} ms "
                  f"({by}), {bnd / ms:.1%} of bound", flush=True)
    return times


def slice_phase(bt):
    """`sample()` on the README trajectory under each kernel selector."""
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    true = np.zeros(T, dtype=int)
    true[30:60] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator(device=DEVICE).manual_seed(42))
    lls = model.logL_batch(np.stack([true, 0 * true, 0 * true + 1]), traj)
    lls = lls.cpu().numpy()
    check(np.argmax(lls) == 0, f"true profile ranks first: {lls}")

    totals = {}
    reset_counts()
    for selector in ("sym", "dense"):
        before = read_counts()
        bt.config.set_rouse_kernel(selector)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bt.sample(traj, model,
                        generator=torch.Generator(device=DEVICE).manual_seed(7))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in read_counts().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt.sample(traj, model, generator=torch.Generator(device=DEVICE).manual_seed(7))
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        best = np.asarray(res.best_profile()[:])
        acc = float(np.mean(best == true))
        post = res.log_marginal_posterior(dE="average")
        steps = sum(s.n_steps_host for s in res.samplers)
        evals = sum(len(s._exhaustive["logLs"]) if s._exhaustive is not None
                    else s.n_steps_host * s.N for s in res.samplers)
        print(f"slice selector={selector}: wall {wall:.3f} s (again: "
              f"{again:.3f} s), AMIS steps "
              f"{steps}, logL evaluations {evals}, best_k {res.best_k()}, "
              f"frame accuracy {acc:.3f}, evidence {np.round(res.evidence, 3).tolist()}, "
              f"launches {ran}", flush=True)
        check(acc >= SLICE_ACCURACY, f"MAP profile >= {SLICE_ACCURACY} frame-correct")
        check(post.shape == (2, T) and np.all(np.isfinite(np.exp(post))),
              "marginal posterior finite, (2, T)")
        check(np.all(np.isfinite(res.evidence)), "finite evidences")
        check(ran[f"kalman_{selector}"] > 0, f"{selector} kernel launched")
        check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
              "no plain version ran on the CUDA path")
        totals = {k: totals.get(k, 0) + v for k, v in ran.items()}
    bt.config.set_rouse_kernel("sym")
    return totals


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import bild_tpu_torch as bt
    from bild_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    bt.config.exact_fp32()

    names = ("kalman_sym", "kalman_dense")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))      # one nvcc per source, at once
    for name in names:
        print(f"build {name}: {_build.build_seconds[name]:.2f} s", flush=True)

    rng = np.random.default_rng(20261016)
    max_abs = kernel_phase(bt, rng)
    times = timing_phase(bt, rng)
    launches = slice_phase(bt)
    lane_kernel_phase(bt, rng, max_abs)
    lock_times = lockstep_phase(bt, rng, max_abs)
    ds_launches = dataset_phase(bt)
    range_phase(bt, rng)

    replaces = {"kalman_sym": "bild_tpu/ops/kalman_sym.py:189",
                "kalman_dense": "bild_tpu/ops/kalman_pallas.py:50"}
    # "ms", "plain_ms" and "bound_ms" at the AMIS step of sample() (one
    # trajectory, P=100); "lockstep_*" at config 3's lockstep launch (L=640,
    # P=128). No single PyTorch call computes the recursion: library_ms is
    # null.
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"bild_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name] + sum(r[name] for r in ds_launches.values()),
        "max_abs_err": max_abs[name],
        "ms": times[(name, 100)][0],
        "plain_ms": times[(name, 100)][1],
        "bound_ms": times[(name, 100)][2],
        "bound_by": times[(name, 100)][3],
        "library_ms": None,
        "lockstep_ms": lock_times[name][0],
        "lockstep_plain_ms": lock_times[name][1],
        "lockstep_bound_ms": lock_times[name][2],
    } for name in names]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
