#!/usr/bin/env python3
"""
Drive bild_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          (from the repository root)

1. Builds the CUDA kernels of ``bild_tpu_torch/csrc/`` (into
   ``bild_tpu_torch/_build/``) and prints the build seconds.
2. Kernel phase: each kernel against its plain PyTorch version on the card
   (float32, rtol 2e-5 per profile) and against the float64 oracle
   (float32: rtol 2e-5; the kernels' float64 build: rtol 1e-9), at the
   shapes `sample()` gives them (P = 2, 198, 100; N=20, d=3, T=100) and at
   the edges of their contract (3 states, 3 distinct localization errors,
   missing frames, an unobserved first frame, out-of-range states -> NaN).
3. Timing phase: kernel and plain version at P = 100 and 8192 (CUDA events).
4. Slice phase: the README model, MultiStateRouse(N=20, D=1, k=5, d=3,
   localization_error=0.1), a T=100 trajectory with a loop at frames 30-60,
   and `bild_tpu_torch.sample()` with its defaults, once per kernel
   selector. The launch counters must show that the run went through the
   selected kernel and never through a plain version.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as the last line ``{"ok": true, "device": {...}}``. Any
failed check raises: the exit code is then non-zero and no result is
printed. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

RTOL_F32 = 2e-5
RTOL_F64 = 1e-9
SLICE_ACCURACY = 0.9
N, D, KSPRING, DIM, T = 20, 1.0, 5.0, 3, 100
DEVICE = "cuda"


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
    shape (P=8192), in the order plain, kernel, kernel, plain."""
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
            times[(name, P)] = (ms, plain_ms)
            print(f"time {name:12s} P={P:5d}  kernel {ms:9.3f} ms "
                  f"({P / ms * 1e3:12.1f} profiles/s)  plain {plain_ms:9.3f} ms "
                  f"({P / plain_ms * 1e3:12.1f} profiles/s)", flush=True)
    return times


def slice_phase(bt):
    """`sample()` on the README trajectory under each kernel selector."""
    from bild_tpu_torch.ops import kalman, kalman_dense, kalman_sym

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

    counters = {
        "kalman_sym": (kalman_sym.msrouse_logL_sym, "launches"),
        "kalman_dense": (kalman_dense.msrouse_logL_dense, "launches"),
        "plain_sym": (kalman_sym.msrouse_logL_sym_torch, "calls"),
        "plain_dense": (kalman_dense.msrouse_logL_dense_torch, "calls"),
        "plain_torch": (kalman.msrouse_logL_batch, "calls"),
    }

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    for selector in ("sym", "dense"):
        before = counts()
        bt.config.set_rouse_kernel(selector)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bt.sample(traj, model,
                        generator=torch.Generator(device=DEVICE).manual_seed(7))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in counts().items()}
        best = np.asarray(res.best_profile()[:])
        acc = float(np.mean(best == true))
        post = res.log_marginal_posterior(dE="average")
        steps = sum(s.n_steps_host for s in res.samplers)
        evals = sum(len(s._exhaustive["logLs"]) if s._exhaustive is not None
                    else s.n_steps_host * s.N for s in res.samplers)
        print(f"slice selector={selector}: wall {wall:.3f} s, AMIS steps "
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
    bt.config.set_rouse_kernel("sym")
    return counts()


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

    for name in ("kalman_sym", "kalman_dense"):
        _build.load(name)
        print(f"build {name}: {_build.build_seconds[name]:.2f} s", flush=True)

    rng = np.random.default_rng(20261016)
    max_abs = kernel_phase(bt, rng)
    times = timing_phase(bt, rng)
    launches = slice_phase(bt)

    replaces = {"kalman_sym": "bild_tpu/ops/kalman_sym.py:189",
                "kalman_dense": "bild_tpu/ops/kalman_pallas.py:50"}
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"bild_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": launches[name],
        "max_abs_err": max_abs[name],
        "ms": times[(name, 100)][0],
        "plain_ms": times[(name, 100)][1],
    } for name in ("kalman_sym", "kalman_dense")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
