#!/usr/bin/env python3
"""
Benchmark: the batched Rouse-Kalman likelihood of bild_tpu_torch on one
NVIDIA GPU, the counterpart of ``bench.py`` (which times bild_tpu).

    python bench_torch.py

The workload is bench.py's: MultiStateRouse(N=20, D=1, k=5, d=3,
localization_error=0.1), two states, one trajectory of T=100 frames drawn
along the true profile ``(arange(T) // 25) % 2`` (here from a
`torch.Generator` seeded 0 on the card), scored for P=8192 profiles drawn
by ``np.random.default_rng(685441950)``: the dispatch shape of the
lockstep dataset runner, where trajectories x proposals land in one kernel
call. ``value`` is the port's shipped default, the packed kernel
(``bild_tpu_torch/csrc/kalman_sym.cu``) at
``config.resolve_matmul("lockstep")``, which is 'exact' unless
``config.set_rouse_matmul`` says otherwise. The same line gives every
likelihood kernel of the port at that shape: the exact tier, the split-bf16
tiers 'split_cov' and 'split' (``csrc/kalman_sym_split.cu``) and the dense
kernel (``csrc/kalman_dense.cu``), each with its plain PyTorch version's
time, the least time of the same work on the card (`kernel_work` with
`bound_ms`, or `split_bound_ms` for the split tiers) and the kernel's share
of it, and the card's name and power limit as nvidia-smi reports them.

Timing: CUDA events around repeated launches of the same call after a
warm-up (`time_ms`), each kernel between two timings of its plain version.
bench.py repeats its kernel inside one on-device ``fori_loop`` (adding
``i * 1e-30`` to ``s2`` so that XLA cannot reuse a result) because
per-call timing over its remote TPU was unreliable. On the card each
launch computes anew and the events time the device, so plain repeated
launches measure the same thing.

Baseline: the sequential float64 NumPy oracle
(``bild_tpu_torch/ops/oracle.py``) on one host thread, on the first 16
profiles, as bench.py's ``vs_baseline``.

No CPU fallback: without a CUDA device ``main()`` exits 1 and prints no
JSON line. Prints ONE JSON line:
  {"metric": "logL_evals_per_sec", "value": ..., "unit": "profiles/s",
   "vs_baseline": ..., "tier": ..., "kernel": ..., "kernels": {...},
   "device": {"name": ..., "power_limit": ...}, ...}
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.ops import counters as ops_counters
from bild_tpu_torch.ops import kalman_dense, kalman_sym
from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

P_BENCH, T_BENCH = 8192, 100
PROFILE_SEED = 685441950
TRAJECTORY_SEED = 0
N_BASE = 16
REPS, PLAIN_REPS = 10, 2
SPLIT_TIERS = ("split_cov", "split")

# NVIDIA H100 SXM peaks (data sheet, at the 700 W power limit): float32
# outside the tensor cores (the exact kernels use none: TF32 is off), dense
# bf16 on the tensor cores (the split tiers' conjugation), HBM3
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12


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


def bound_ms(flops, nbytes):
    """The least time of that work on the card and what sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def split_bound_ms(L, P, T, n, N, d, q, observed):
    """The least time of `kernel_work`'s work in a split tier: the
    conjugation's least FLOP (``2 N^3 + N (N+1) (2N+1) / 2`` per copy and
    profile-frame) as three bf16 products at the tensor cores' peak, the
    rest of the likelihood at the float32 peak, or the HBM bytes, whichever
    is longer."""
    flops, nbytes = kernel_work(L, P, T, n, N, d, q, observed)
    conj = L * P * (T - 1) * q * (2 * N ** 3 + N * (N + 1) * (2 * N + 1) // 2)
    t_ops = (3 * conj / PEAK_FLOPS_BF16 + (flops - conj) / PEAK_FLOPS_F32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, reps):
    """Milliseconds per call of ``fn`` on the card: one warm-up call, then
    ``reps`` calls between two CUDA events."""
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


def counters():
    """Every kernel's launch counter and every plain version's call
    counter, as (function, attribute) by name: a read-only view of the
    port's registry (`bild_tpu_torch.ops.counters.COUNTERS`), so that no
    list of names is kept here."""
    return types.MappingProxyType(ops_counters.COUNTERS)


def card():
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout
    name, limit = (x.strip() for x in out.strip().rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def true_profile(T=T_BENCH):
    """bench.py's true profile: states alternating every 25 frames."""
    return ((np.arange(T) // 25) % 2).astype(int)


def bench_profiles(P=P_BENCH, T=T_BENCH):
    """bench.py's ``(P, T)`` int32 profiles, two states, i.i.d. per frame."""
    rng = np.random.default_rng(PROFILE_SEED)
    return rng.integers(0, 2, size=(P, T)).astype(np.int32)


def rouse_model(device=bt.config.DEFAULT_DEVICE, dtype=torch.float32,
                looppositions=None):
    """bench.py's and bench_e2e.py's Rouse model: N=20, D=1, k=5, d=3,
    localization error 0.1; two states, or those of ``looppositions``."""
    kw = {} if looppositions is None else dict(looppositions=looppositions)
    return bt.models.MultiStateRouse(20, 1.0, 5.0, d=3, localization_error=0.1,
                                     **kw, device=device, dtype=dtype)


def workload(P=P_BENCH, T=T_BENCH, device=bt.config.DEFAULT_DEVICE,
             dtype=torch.float32):
    """``(model, trajectory, profiles)``: `rouse_model`, one trajectory
    along `true_profile` from a generator seeded `TRAJECTORY_SEED` on the
    model's device, and `bench_profiles`."""
    model = rouse_model(device, dtype)
    traj = model.trajectory_from_loopingprofile(
        true_profile(T),
        generator=torch.Generator(device=model.device).manual_seed(TRAJECTORY_SEED))
    return model, traj, bench_profiles(P, T)


def likelihoods(model, traj, profiles):
    """``{name: (kernel call, plain call)}`` on these inputs: the packed
    kernel's tiers ("kalman_sym" is the exact tier, "kalman_sym_split_cov"
    and "kalman_sym_split" the split ones) and the dense kernel. On CPU
    tensors the kernel wrappers run their plain versions."""
    s2, Cind = model._noise_arrays(traj)
    ops = model.sym_operators()
    prof = torch.as_tensor(profiles, device=traj.data.device)
    args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
            s2, Cind, prof, traj.data, traj.valid)
    fns = {}
    for tier in ("exact",) + SPLIT_TIERS:
        name = "kalman_sym" if tier == "exact" else f"kalman_sym_{tier}"
        fns[name] = (functools.partial(kalman_sym.msrouse_logL_sym, *args, ops=ops,
                                       matmul=tier),
                     functools.partial(kalman_sym.msrouse_logL_sym_torch, ops,
                                       *args[6:], matmul=tier))
    fns["kalman_dense"] = (functools.partial(kalman_dense.msrouse_logL_dense, *args),
                           functools.partial(kalman_dense.msrouse_logL_dense_torch,
                                             *args))
    return fns


def evaluate(model, traj, profiles):
    """One call of each kernel wrapper of `likelihoods`: ``({name: (P,)
    float64 logLs}, counts)``, where counts are the launches and plain calls
    (`counters`) that those calls made."""
    before = ops_counters.read()
    out = {name: kern().cpu().numpy().astype(np.float64)
           for name, (kern, _) in likelihoods(model, traj, profiles).items()}
    counts = {k: v - before[k] for k, v in ops_counters.read().items()}
    return out, counts


def baseline(model, traj, profiles, n=N_BASE):
    """``(seconds per profile, logLs)`` of the float64 NumPy oracle on the
    first ``n`` profiles, one after another on one host thread."""
    h = model.host
    err = np.asarray(model._get_noise(traj))
    data = traj[:]
    t0 = time.perf_counter()
    vals = [msrouse_logL_numpy(h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"],
                               h["w"], err, p, data) for p in profiles[:n]]
    return (time.perf_counter() - t0) / n, np.array(vals)


def measure(model, traj, profiles, reps=REPS):
    """Every kernel of `likelihoods` on the card: one checked call each
    (every kernel launched, no plain version ran), then CUDA-event times
    in the order plain, kernel, kernel, plain. Returns ``{name:
    {"profiles_per_s", "ms", "plain_ms", "bound_ms", "bound_by",
    "share_of_bound"}}``."""
    if traj.data.device.type != "cuda":
        raise ValueError("measure() times the card's kernels: build the "
                         f"model on a CUDA device, not {traj.data.device}")
    _, ran = evaluate(model, traj, profiles)
    if not (ran["kalman_sym"] == 3 and ran["kalman_sym_split"] == 2
            and ran["kalman_dense"] == 1) or any(
                v for k, v in ran.items() if k.startswith("plain")):
        raise RuntimeError(f"the likelihood calls did not all launch their "
                           f"kernels: {ran}")
    s2, _ = model._noise_arrays(traj)
    n, N = model.Bs.shape[:2]
    P, T = profiles.shape
    shape = (1, P, T, n, N, traj.data.shape[1], s2.shape[0], int(traj.valid.sum()))
    out = {}
    for name, (kern, plain) in likelihoods(model, traj, profiles).items():
        p1, k1, k2, p2 = (time_ms(f, r) for f, r in ((plain, PLAIN_REPS), (kern, reps),
                                                     (kern, reps), (plain, PLAIN_REPS)))
        ms = (k1 + k2) / 2
        bnd, by = (split_bound_ms(*shape) if name.startswith("kalman_sym_split")
                   else bound_ms(*kernel_work(*shape)))
        out[name] = {"profiles_per_s": P / ms * 1e3, "ms": ms,
                     "plain_ms": (p1 + p2) / 2, "bound_ms": bnd, "bound_by": by,
                     "share_of_bound": bnd / ms}
    return out


def bench_line():
    """bench.py's JSON object for the port, measured on the card."""
    model, traj, profiles = workload()
    tier = bt.config.resolve_matmul("lockstep")
    name = "kalman_sym" if tier == "exact" else f"kalman_sym_{tier}"
    kernels = measure(model, traj, profiles)
    sec, _ = baseline(model, traj, profiles)
    rate = kernels[name]["profiles_per_s"]
    P, T = profiles.shape
    return {"metric": "logL_evals_per_sec", "value": round(rate, 1),
            "unit": "profiles/s", "vs_baseline": round(rate * sec, 2),
            "tier": tier, "kernel": name, "P": P, "T": T,
            "baseline_profiles_per_s": 1.0 / sec, "kernels": kernels,
            "device": card()}


def main():
    if not torch.cuda.is_available():
        print("bench_torch.py: no CUDA device (torch.cuda.is_available() is "
              "false); it measures the card's kernels only", file=sys.stderr)
        return 1
    bt.config.exact_fp32()
    print(json.dumps(bench_line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
