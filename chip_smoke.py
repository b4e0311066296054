#!/usr/bin/env python3
"""
Drive bild_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--parent DIR]     (from the repository root)

1. Builds the CUDA kernels of ``bild_tpu_torch/csrc/`` (into
   ``bild_tpu_torch/_build/``), one nvcc per source, and the split
   kernel's probe build, all at once, and prints the build seconds.
2. Kernel phase: each kernel against its plain PyTorch version on the card
   (float32, rtol 2e-5 per profile) and against the float64 oracle
   (float32: rtol 2e-5; the kernels' float64 build: rtol 1e-9), at the
   shapes `sample()` gives them (P = 2, 198, 100; N=20, d=3, T=100) and at
   the edges of their contract (3 states, 3 distinct localization errors,
   missing frames, an unobserved first frame, out-of-range states -> NaN).
3. Timing phase: kernel and plain version at P = 100 (CUDA events),
   beside the least time of the same work on the card (`kernel_work`: the
   likelihood's least FLOP and bytes, the same for both kernels; `bound_ms`:
   FLOP over the float32 peak or HBM bytes over its rate; both in
   bench_torch.py, with `split_bound_ms` and `time_ms`).
3b. Bench phase: bench_torch.py's measurement at its shape (L=1, P=8192,
   T=100; bench.py's workload): each kernel (exact, 'split_cov', 'split',
   dense) against its plain version there, then its JSON line (the
   default tier's profiles/s, against the float64 oracle, every kernel's
   time beside its plain version's and its bound), printed.
4. Slice phase: the README model, MultiStateRouse(N=20, D=1, k=5, d=3,
   localization_error=0.1), a T=100 trajectory with a loop at frames 30-60,
   and `bild_tpu_torch.sample()` with its defaults, once per kernel
   selector ('auto', the default, 'sym' and 'dense'; each phase that sets
   a selector restores the one it found); every sampler's steps replay
   one CUDA graph of the lockstep step at one lane, and under 'sym' and
   'auto' every step launches the cluster plan (``kalman_sym_cluster`` at
   least the steps; under 'auto' the dataset runs launch the dense kernel
   and no tile plan of the packed one). The whole counter registry
   (`ops.counters`) must show
   that the run went through the selected kernel, csrc/gamma_accept.cu
   and csrc/cfc_solve.cu and never through a plain version; the first
   call captures one graph and a second from the same seed none, with the
   same bits. Printed: both walls, the second split into steps, sampler
   construction and the choice loop, and from a traced third call the busy
   share, host launch calls per AMIS step and each kernel's device time.
4b. Bench_e2e phase: bench_e2e_torch.py's config 2 (`sample()` on its
   two-loop trajectory, the float32 kernel against the float64 oracle on
   64 profiles), its dict printed: frame accuracy >= 0.90, kernel parity
   within rtol 2e-5, the kernel launched and no plain version. Configs 3-7
   run in the phases below, on the data of bench_e2e_torch.py's
   `config3_data`, `config4_data` and `ggm_data`.
5. Lane phase: both kernels on one lane batch (L=6 trajectories with their
   own missing frames, P=37, T=100, out-of-range rows in two lanes), in
   float32 and float64, against the plain version, the f64 oracle and six
   single-lane launches of the same kernel (bit for bit).
5b. Cluster phase: the packed kernel's cluster plan (csrc/kalman_sym.cu,
   `kalman_sym_cluster_kernel`, which sample()'s step at one trajectory
   takes) at L=1 with P = 1, 7, 37, 100, 128 and at L = 2, 6 with P=37,
   in two and three states, one and three localization errors, float32
   and float64, with missing frames (frame 0 among them) and out-of-range
   rows: against the same launch forced onto the tile plan, bit for bit;
   against the plain version and the f64 oracle (rtol 2e-5, float64
   1e-9); each launch counted in ``kalman_sym_cluster``. At sample()'s
   step, the tile plan and clusters of 8 and 16 timed in turns, and the
   clusters the card holds at once.
6. Lockstep phase: both kernels against their plain versions and against
   their own float64 build at every lane shape the dataset run below
   launches (per 64-trajectory chunk: scout L=320, refine L=192, P=128;
   the boundary climb L=64, P=9), at L=640, P=128 (config 3 in one
   chunk), at config 4's launches (scout L=112, refine L=48; T=1000, three
   states) and at config 5's (scout L=5,120, refine L=3,072). At L=640 the
   profiles permuted within each lane must give the permuted results, and
   7 profiles launched alone and three lanes launched alone (one profile
   per block) the same results, bit for bit (no tile or block shares
   anything between profiles); both kernels are timed beside their bound
   at L=640, the adaptive round and the four config 4 and 5 launches, and
   each launch's plan (tile, blocks, shared memory) is printed. Float32
   (the covariance recursion carried in float64) against its float64
   build is held to rtol 2e-5 per profile at every shape, and at T=1000
   also to bild_tpu's 0.11 nats per trajectory and profile family after
   the shift its profiles share (`BILD_TPU_CENTERED_T1000`), printed
   beside the plain float32 version's own drift.
6a. Parent kernel phase: with a checkout of the parent commit at
   _chip/parent (or ``--parent DIR``), its two float32 likelihood kernels,
   built from its sources and launched with its plan (the tile plan),
   against this checkout's bit for bit and timed in turns (parent,
   change, change, parent) at the shapes of PERF.md's kernel table:
   sample()'s step (L=1, P=100; this checkout's cluster plan, and its
   tile plan timed beside it), the bench shape (L=1, P=8192), config 3's
   lockstep launch (L=640, P=128), config 4's scout (L=112, T=1000, three
   states) and config 5's scout (L=5,120).
6b. Ladder phase: both float32 kernels against their own float64 build
   at tools/parity_ladder.py's shapes (T=100 and 300 with two states,
   T=1000 with config 4's three; 64 every-frame random profiles, 64
   segment profiles, the constant ones), the max relative error, nats and
   centered nats printed beside bild_tpu's TPU numbers (BASELINE.md), four
   profiles per shape against the numpy float64 oracle; rtol 2e-5 at
   every rung, and 0.11 centered nats per family at T=1000.
6b'. Split phase: the packed kernel's split-bf16 tiers ('split_cov',
   'split'; csrc/kalman_sym_split.cu, the conjugation on wgmma) against their plain
   split versions at `kernel_cases()` and at the dataset run's lockstep
   launches ('split_cov' rtol 1e-4; 'split' within twice its plain
   version's error against the float64 build), and at those launches cut
   to one frame ('split') and two ('split_cov'): each tier within 1e-6 of
   its plain version, and shifted from the exact tier as its plain version
   is; at each of those launches the probe build's frame 1 of the first
   tile (the update contraction's Cw and 1/S and the propagated means)
   against the plain steps on the same inputs (`PROBE_RTOL`), and at least
   twice that from the other tier's steps; bit for bit across
   permuted, subset and single-lane launches at L=640; the ladder's
   rungs against the float64 build beside bild_tpu's TPU readings
   ('split_cov' within 1e-4 and 0.1 centered nats at T=100; for 'split'
   those bars gate the default); CUDA-event times of exact, split_cov and
   split at L=1, 640 and 5,120 beside `split_bound_ms`; config 3's
   lockstep `sample_dataset` under 'exact' and 'auto' in one call (wall,
   busy share, accuracy bars, split launches). The default may be 'auto'
   only if 'split' meets its T=100 bars and 'auto' is no slower.
6c. Tiers phase: tools/parity_tiers.py's configuration (N=20, d=3, T=100,
   two states, 64 random profiles): sym, dense and the plain recursion in
   float32, the square-root filter (`ops.kalman_sqrt`) and the
   temporal-parallel filter (`experimental.assoc_kalman`) in float32 and
   float64, each against the numpy float64 oracle with its profiles per
   second (CUDA events), beside bild_tpu's TPU readings
   (PARITY_TIERS_r04.json); batched QR times at the filter's shapes; then
   the square-root filter at the ladder's T=1000 rung, float32 against its
   float64 run, beside both kernels' drift there. Bars: float64 within
   1e-9 of the oracle (of the dense float64 build at T=1000), sqrt float32
   within 1e-6 of the oracle at T=100 and within 0.11 centered nats per
   family at T=1000.
6d. Step kernel phase: the two kernels of the AMIS step that replace
   device loops of bild_tpu (not Pallas kernels), on every input the main
   path gives them (config 3's lockstep `sample_batch` and each run of the
   graph phase under 'sym', config 4's three states and the README and GGM
   `sample()` among them, run eagerly so that each step's calls are
   recorded): csrc/cfc_solve.cu (the CFC proposal's fixed-point solve, a
   group of threads per slot; bild_tpu's `lax.while_loop`) against the
   plain solve, float32 within 4 ulp, the inputs in float64 within 1e-12
   relative, converged flags and non-finite entries equal;
   csrc/gamma_accept.cu (the gamma sampler's rejection rounds, a block per
   range of a lane's entries; jax.random.gamma's loop) against its plain
   rounds within 4 ulp, no entry exhausted, also on float32 shapes
   1e5-1e10 (tens of rounds). Each timed by its device time (launches
   replayed in one CUDA graph) at config 3's scout call, `sample()`'s and
   config 4's three-state call (CFC) or the degenerate case (gamma), beside
   the bound of the iterations or rounds it takes, the gamma kernel also
   beside `torch._standard_gamma`'s device time there; with a checkout of
   the parent commit at _chip/parent (or ``--parent DIR``), the parent's
   two kernels on the same inputs, in turns. `nvcc -Xptxas -v` of both
   sources is printed; the CFC kernel's group instantiations must use no
   stack frame.
7. Dataset phase (bench_e2e.py config 3): 128 trajectories of T=100 made by
   the port's batched generator, `parallel.sample_dataset` with informed
   init, the scout/refine schedule, marginals, the boundary climb and chunk
   checkpoints, once per kernel selector: accuracy against the truths, the
   launch counters, a rerun that loads both chunks, the device-busy share
   under torch.profiler, and the per-k checkpointed `sample_batch` equal to
   the all-k one on a 16-trajectory chunk.
8. Adaptive phase: config 3 through `sample_dataset(schedule='adaptive',
   chunk_size=128)` (k_max=4, N=128, informed init, init_steps=4,
   steps_per_round=2, max_steps_per_k=24, samplesize=4096) under each
   selector: accuracy against the same bars, fewer likelihood
   evaluations per trajectory than the lockstep schedule's 5,632, the
   launch counters, a rerun from the chunk checkpoint and a second run
   from the same seed (identical arrays), the device-busy share, and
   `sample_batch_adaptive` on the chunk with ``evals == N * steps``. The
   lockstep phase above holds both kernels at its launches (bootstrap
   L=384, round L=128 with trajectories in two slots, P=128) and times the
   round.
8b. Config 4 phase (bench_e2e.py config 4): 16 three-state trajectories
   of T=1000 through `sample_batch(k_max=6, steps_per_k=12, N=128,
   informed_init, scout_steps=4, refine_top=3)` under each selector:
   frame / switch-count accuracy >= 0.97 / 0.50, the launch counters,
   wall, peak device memory and the device-busy share of a traced rerun
   (same bits); the smallest evidence gap between the best and the next k
   beside the kernel's float32 drift at config 4's launches.
8b'. Graph phase: the dataset runners and `sample()` replay one CUDA graph
   of their AMIS step (`parallel.graphs`; every run since the start does)
   and, through the private `graphs._EAGER`, run their eager step: config
   3's lockstep `sample_dataset` and adaptive schedule under each
   selector, config 4 under each, the README `sample()` under each, the
   `ggm_model` example's `sample()`, GGM configs 6 and 7, each in both
   modes in one call. Per
   mode: wall, device-busy share and host launch calls per AMIS step of a
   traced run, captures and replays, the gamma sampler's exhaustion
   counter, the peak device memory allocated and reserved. Graphed equals
   eager bit for bit (evidences, MAP profiles, mom_ok, and the marginals,
   climbed profiles and evaluations where the run has them; for
   `sample()` every sampler's evidences and state, the best profile and
   the averaged marginals); every accuracy bar; the graphed runs launch
   the selected kernel and the CFC and gamma kernels through replays, and
   no plain version; a `sample()` captures one graph, a second none; a
   sampler step that reads the host fails to capture and raises. Then the
   copies into and out of the README `sample()`'s graph per `steps(n)`
   call (`copy_cost`): tensors, bytes, host and device microseconds.
8c. Config 5p phase (bench_e2e.py config5(postproc=True)): 10 chunks of
   1,024 trajectories (T=100, data made on the card per chunk) through
   `sample_batch(k_max=4, ..., marginals)`, the boundary climb and the
   evidence-averaged marginal credibility, under 'sym': accuracy >= 0.97
   / 0.75, the climb within 0.001, credibility >= 0.97; wall,
   trajectories per second, first and steady chunk seconds, peak memory.
9. CLI phase: config 3 written as a two-locus CSV and run through ``python
   -m bild_tpu_torch`` in subprocesses with no ``--device`` (so on the
   card): lockstep with marginals, boundary climb, dwell times and chunk
   checkpoints; a rerun (identical npz); ``--adaptive``; ``--fit-params 1
   --fit-subset 32``. Each process reports its counters: the native CSV
   parser ran, every inference likelihood went through the kernel, and
   plain calls happened only in the calibration's M-step (counted apart).
10. Checkpoint phase: the README `sample()` saved and loaded on the card;
   a loaded sampler's next steps equal the uninterrupted ones bit for bit.
10b. Examples phase: the four `bild_tpu_torch.examples` at full size on
   the card (imported, `main()` with no device), each against a bar set
   from what bild_tpu's own example printed (`EXAMPLE_REFERENCE`), the
   Rouse ones through the sym kernel only (the calibration's M-step
   counted apart), the GGM one through no Rouse recursion; and a
   user-defined model (only `nStates`, `transitions`, `logL_batch`)
   through `sample()` on the card, returning a tensor and a numpy array.
11. Range phase: the dense kernel at the largest chains one warp takes
   (float32 N=168 at q=1 and N=120 at q=3, float64 N=116), its operators
   then in global memory, against its plain version or the f64 oracle;
   the float32 ones with the float32 covariance of the large-N plan
   (counted in ``kalman_dense_cov32``), which no main-path launch takes.
12. GGM phase: the Generic Gaussian model, which runs no Rouse recursion
   and so no kernel of ``csrc/`` (its launch and plain-call counters must
   stay at zero through the phase). Interval tables and gather-sums on the
   card against the float64 host oracle (`ggm_parity`); bench_e2e.py's
   config 6 (two-state two-locus Rouse, B=64, T=100) and config 7 (the
   same with T_band=128, B=16, T=1000, informed init) through
   `sample_batch(k_max=4, steps_per_k=12, N=128, scout_steps=4,
   refine_top=3)` at full size, against accuracy bars, with the table build
   timed apart from the sampling, the table bytes, the device-busy share
   and the device time by operation; on config 6 also the per-k
   checkpointed schedule against the all-k one (bit for bit),
   `sample_dataset(schedule='adaptive')` and `calibrate_ggm(rounds=1)` from
   a spec 20 % off the truth (time per Adam step, the objective one CUDA
   graph); and
   `sample()` on one trajectory with its `save_results`/`load_results`
   round trip.
13. Mesh phase: config 3 (``chunk_size=64``, informed init, scout/refine,
   marginals) split over ranks of a `torch.distributed` world. (a) A
   one-rank NCCL world: `sample_dataset(mesh=)` and
   `sample_dataset_sharded(mesh=)` equal their mesh-free runs bit for bit,
   through the kernel. (b) Two processes sharing the card over gloo, each
   ``python -m bild_tpu_torch shard{r}.csv --process-local --mesh`` on its
   own CSV shard of 64 trajectories (interleaved ids): both ``--out``
   files are identical, equal the one-process ``--process-local`` run on
   the concatenated CSV bit for bit and meet the dataset bars; rank 0
   alone wrote checkpoint files; every process launched the kernel. No
   run on two GPUs: one card serves both processes.
14. Assoc phase: `MultiStateRouse.logL_batch_assoc` and its filter on the
   card. tools/assoc_crossover.py's grid (T = 1024, 4096, 16384 x P = 1, 8,
   and T=1024 x P=64; N=20, d=3): the filter, sym, dense and the plain
   recursion in float32 on the same profiles, ms per call and the filter's
   peak device memory; float64 within 1e-8 of the dense kernel's float64
   build at T=1024 and 8192 with missing frames; a one-rank NCCL ``time``
   mesh within 1e-12 of ``mesh=None``; two processes sharing the card over
   gloo, frames split in two, within 1e-10 of one process (T=8192,
   float64).

On the card the dataset runners replay a CUDA graph of their step: a
replay counts, in each kernel's launch counter, what the captured step
launched (`parallel.graphs`), so the counters read as in an eager run.

Prints the card's name and power limit, bench_torch.py's JSON line and
config 2's dict (phases 3b and 4b), one JSON line of per-kernel results
(the two TPU kernels' ports, the packed kernel's cluster plan, the split
tiers' kernel, the CFC solve's and the gamma sampler's, and the graph
phase's readings), and as the last line ``{"ok": true,
"device": {...}}``. Any
failed check raises: the exit code is then non-zero and no result is
printed. Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import datetime
import functools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import bench_e2e_torch
import bench_torch
from bench_e2e_torch import (THREE_STATES, config3_data, config4_data, ggm_data,
                             ggm_model, switch_counts, truth_profiles)
from bench_torch import bound_ms, kernel_work, split_bound_ms, time_ms
from bild_tpu_torch.ops import counters

RTOL_F32 = 2e-5
RTOL_F64 = 1e-9
SLICE_ACCURACY = 0.9
# likelihood evaluations per trajectory of config 3's lockstep schedule
# (ADAPTIVE_34_r05.json): the adaptive schedule must spend fewer
LOCKSTEP_EVALS = 5632
# the dataset phase's bars; bild_tpu's own run of this configuration
# recorded 0.993 and 0.852 (PERF_r04.json)
DATASET_FRAME_ACCURACY = 0.97
DATASET_SWITCH_ACCURACY = 0.75
N, D, KSPRING, DIM, T = 20, 1.0, 5.0, 3, 100
DEVICE = "cuda"
# the counters of the Rouse likelihood (`ops.counters`): the GGM runs none
ROUSE_COUNTERS = ("kalman_sym", "kalman_sym_split", "kalman_sym_cluster", "kalman_dense",
                  "kalman_dense_cov32",
                  "plain_sym", "plain_dense", "plain_torch")


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


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def launched_kernel(selector, label):
    """The likelihood counter that a run of ``selector`` must move: under
    'auto' the dense kernel at the dataset runners' launches and the
    packed kernel's cluster plan at `sample()`'s step (L=1, P=100)."""
    if selector != "auto":
        return f"kalman_{selector}"
    return "kalman_sym_cluster" if label.endswith("sample()") else "kalman_dense"


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


# The launches of the cluster phase: sample()'s single-trajectory step
# (L=1, P=100) and the shapes around it, one profile to more than a
# cluster's share, and two lane launches (L=6 takes the tile plan; its
# cluster launch is forced)
CLUSTER_SHAPES = ((1, 1), (1, 7), (1, 37), (1, 100), (1, 128), (2, 37), (6, 37))


def cluster_phase(bt):
    """The exact tier's cluster plan (csrc/kalman_sym.cu,
    `kalman_sym_cluster_kernel`) at `CLUSTER_SHAPES`, in two and three
    states, one and three localization errors (q=1, 3), float32 and
    float64, with about 5 % of the frames missing (frame 0 of lane 0
    among them) and out-of-range rows (NaN): the cluster launch (forced
    where the planner takes the tile plan) against the same launch forced
    onto the tile plan, bit for bit; against the plain version (float32
    rtol 2e-5, float64 1e-9) and the float64 oracle on two rows per lane
    (the same bars); NaN exactly on the out-of-range rows; one cluster
    launch counted in ``kalman_sym_cluster`` per cluster launch and none
    for the tile plan's. At sample()'s step (n=2, q=1, float32), in turns
    (tile, C=8, C=16, C=16, C=8, tile): the tile plan, clusters of 8
    (the planner's) and of 16, with the bound. Returns ``{"max_abs":
    float32 max abs error against the plain version, "ms", "plain_ms",
    "bound_ms", "bound_by", "ms_16", "tile_ms", "slots": {C: clusters the
    card holds}}``."""
    import functools

    from bild_tpu_torch.ops import kalman_sym
    from bild_tpu_torch.ops.kalman_dense import sm_count
    from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym, msrouse_logL_sym_torch
    from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

    slots = {C: kalman_sym._cluster_slots("f32", 0, C) for C in (8, 16)}
    print(f"cluster plan: the card holds {slots} clusters of each size at once "
          f"(cudaOccupancyMaxActiveClusters), {sm_count(0)} SMs", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    out = {"max_abs": 0.0, "slots": slots}
    for n, loops in ((2, (None, (0, -1))), (3, THREE_STATES)):
        for q, err in ((1, 0.1), (3, (0.1, 0.2, 0.15))):
            for dtype, rtol in ((torch.float32, RTOL_F32), (torch.float64, RTOL_F64)):
                model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM, looppositions=loops,
                                                  localization_error=err, device=DEVICE,
                                                  dtype=dtype)
                ops = model.sym_operators()
                h = model.host
                sfx = "f32" if dtype == torch.float32 else "f64"
                for L, P in CLUSTER_SHAPES:
                    batch = model.trajectories_from_loopingprofiles(
                        truth_profiles(np.random.default_rng(L * 1000 + P), L, T, n),
                        generator=torch.Generator(device=DEVICE).manual_seed(P))
                    valid = torch.rand((L, T), generator=gen, device=DEVICE) > 0.05
                    valid[0, 0] = False
                    ydata = torch.where(valid[..., None], batch.data, 0.0).contiguous()
                    prof = lane_profiles(gen, L, P, n, T)
                    nan_rows = np.zeros((L, P), dtype=bool)
                    if P > 1:
                        prof[0, P - 1, T // 2] = n
                        prof[L - 1, 0, T // 3] = -1
                        nan_rows[0, P - 1] = nan_rows[L - 1, 0] = True
                    traj0 = bt.Trajectory(ydata[0], valid[0])
                    s2, Cind = model._noise_arrays(traj0)
                    args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                            s2, Cind, prof, ydata, valid)
                    plan = kalman_sym.sym_plan(
                        L, P, n, N, DIM, len(s2), ydata.element_size(), sms=sm_count(0),
                        cluster_slots=functools.partial(kalman_sym._cluster_slots, sfx, 0))
                    force = None if plan.cluster else "cluster"
                    counters.reset(["kalman_sym_cluster"])
                    got = msrouse_logL_sym(*args, ops=ops, _force=force)
                    launched = counters.read(["kalman_sym_cluster"])["kalman_sym_cluster"]
                    tile = msrouse_logL_sym(*args, ops=ops, _force="tile")
                    tile_launched = (counters.read(["kalman_sym_cluster"])["kalman_sym_cluster"]
                                     - launched)
                    plain = msrouse_logL_sym_torch(ops, s2, Cind, prof, ydata, valid)
                    torch.cuda.synchronize()
                    got, tile, plain = (x.cpu().numpy() for x in (got, tile, plain))
                    data_nan = np.where(valid.cpu().numpy()[..., None],
                                        ydata.cpu().numpy(), np.nan)
                    noise = np.asarray(model._get_noise(traj0))
                    prof_np = prof.cpu().numpy()
                    orc_err = 0.0
                    for lane in range(L):
                        rows = [r for r in range(P) if not nan_rows[lane, r]][:2]
                        orc = np.array([msrouse_logL_numpy(
                            h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"], noise,
                            prof_np[lane, r], data_nan[lane]) for r in rows])
                        orc_err = max(orc_err, rel_err(got[lane, rows], orc))
                    e_plain = rel_err(got, plain) if (~nan_rows).any() else 0.0
                    same = np.array_equal(got, tile, equal_nan=True)
                    how = (f"planned: clusters of {plan.cluster}, {plan.tile} profiles each"
                           if plan.cluster else
                           f"forced (the planner takes {plan.tile}-profile tiles)")
                    line = (f"cluster n={n} q={len(s2)} {str(dtype)[6:]:7s} L={L} P={P:3d} "
                            f"{how}: against the tile plan "
                            f"{'same bits' if same else 'DIFFER'}; plain rel {e_plain:.2e}, "
                            f"oracle rel {orc_err:.2e} (rtol {rtol})")
                    print(line, flush=True)
                    check(launched == 1 and tile_launched == 0,
                          f"{line}: one cluster launch counted ({launched}), none for the "
                          f"tile plan ({tile_launched})")
                    check(same, f"{line}: the cluster plan gives the tile plan's bits")
                    check(np.array_equal(np.isnan(got), nan_rows),
                          f"{line}: NaN exactly on the out-of-range rows")
                    check(e_plain <= rtol and orc_err <= rtol,
                          f"{line}: plain and oracle within {rtol}")
                    if dtype == torch.float32:
                        fin = ~nan_rows
                        out["max_abs"] = max(out["max_abs"], float(
                            np.max(np.abs(got[fin] - plain[fin]), initial=0.0)))
                    if (n, len(s2), dtype, L, P) != (2, 1, torch.float32, 1, 100):
                        continue
                    runs = {"tile": lambda: msrouse_logL_sym(*args, ops=ops, _force="tile"),
                            8: lambda: msrouse_logL_sym(*args, ops=ops),
                            16: lambda: msrouse_logL_sym(*args, ops=ops, _force=16)}
                    check(plan.cluster == 8, f"sample()'s step plans clusters of 8: {plan}")
                    times = {k: [] for k in runs}
                    for k in ("tile", 8, 16, 16, 8, "tile"):
                        times[k].append(time_ms(runs[k], 20))
                    p1, p2 = (time_ms(lambda: msrouse_logL_sym_torch(
                        ops, s2, Cind, prof, ydata, valid), 2) for _ in range(2))
                    ms = {k: sum(v) / len(v) for k, v in times.items()}
                    bnd, by = bound_ms(*kernel_work(L, P, T, n, N, DIM, 1, int(valid.sum())))
                    out.update(ms=ms[8], ms_16=ms[16], tile_ms=ms["tile"],
                               plain_ms=(p1 + p2) / 2, bound_ms=bnd, bound_by=by)
                    print(f"time cluster sample() step L=1 P=100 (in turns: tile, 8, 16, 16, "
                          f"8, tile): clusters of 8 {ms[8]:.4f} ms ({bnd / ms[8]:.2%} of "
                          f"bound), of 16 {ms[16]:.4f} ms, tile plan {ms['tile']:.4f} ms, "
                          f"plain {(p1 + p2) / 2:.3f} ms; bound {bnd:.4f} ms ({by}); "
                          f"{ms['tile'] / ms[8]:.2f}x the tile plan", flush=True)
    return out


# (label, lanes, profiles per lane, trajectories the lanes cycle over,
# frames, states): the launches of the dataset phase. Per 64-trajectory
# chunk the scout steps run 5 k x 64 lanes and the refine steps 3 x 64, 128
# proposals each; the boundary climb scores 2 Kb + 1 = 9 candidates (Kb =
# k_max = 4) of each of up to 64 trajectories; config 3 in one chunk runs
# 640 lanes. The adaptive phase's chunk of 128 bootstraps 3 k x 128 lanes,
# and each round advances 128 gathered slots, here 96 trajectories and 32
# of them twice (budget reallocation gives a trajectory several slots).
# Config 4 (16 three-state trajectories of T=1000, k_max=6) scouts 7 x 16
# lanes and refines 3 x 16; config 5 (chunks of 1,024 trajectories of
# config 3's shape, k_max=4) scouts 5 x 1,024 and refines 3 x 1,024, its
# lanes here cycling over config 3's 128 trajectories.
LOCKSTEP_SHAPES = (
    ("chunk scout", 320, 128, 64, 100, 2),
    ("chunk refine", 192, 128, 64, 100, 2),
    ("boundary climb", 64, 9, 64, 100, 2),
    ("one chunk of 128", 640, 128, 128, 100, 2),
    ("adaptive bootstrap", 384, 128, 128, 100, 2),
    ("adaptive round", 128, 128, 96, 100, 2),
    ("config 4 scout", 112, 128, 16, 1000, 3),
    ("config 4 refine", 48, 128, 16, 1000, 3),
    ("config 5 scout", 5120, 128, 128, 100, 2),
    ("config 5 refine", 3072, 128, 128, 100, 2),
)
# The shapes above up to `PR6_LANES` lanes of T=100 keep the profiles and
# masks drawn on the host by `make_profiles`, on which RTOL_F32 was set:
# sym's tail passes 2e-5 on other draws (config 5's launches below; PERF.md
# section 6).
PR6_LANES = 640
# the shapes timed in the lockstep phase
TIMED_SHAPES = ("one chunk of 128", "adaptive round", "config 4 scout",
                "config 4 refine", "config 5 scout", "config 5 refine")
# the shape of the permutation, subset and lane-alone checks
CHECKED_SHAPE = "one chunk of 128"
# Float32 against its own float64 build: rtol RTOL_F32 per profile at
# every shape (set from the worst of 81,920 profiles at T=100 when the
# float32 kernels still stored the covariance in float32: sym, 1.84e-5),
# and at T=1000 (three states: config 4's launches, the ladder's last
# rung) also bild_tpu's own bar, 0.11 nats after the shift the profiles of
# one family share (`centered_nats`; its sym exact tier on a TPU v5e,
# BASELINE.md:59-67). The float32 kernels carry the covariance recursion
# in float64: stored in float32 they drifted 0.32-0.34 (sym) and
# 0.14-0.16 (dense) centered nats at T=1000 on an H100, above config 4's
# smallest evidence gap between the best and the next k (config4_phase
# prints both).
BILD_TPU_CENTERED_T1000 = 0.11


def lane_profiles(gen, L, P, n, T):
    """``(L, P, T)`` int32 profiles made on the card (for the lockstep
    shapes beyond `PR6_LANES`: `make_profiles`' host loop is slow at
    655,360 profiles): even rows piecewise constant with about 0-6
    switches, odd rows i.i.d. per frame."""
    iid = torch.randint(0, n, (L, P, T), generator=gen, device=DEVICE)
    k = torch.randint(0, 7, (L, P, 1), generator=gen, device=DEVICE)
    switch = torch.rand((L, P, T), generator=gen, device=DEVICE) < k / (T - 1)
    switch[..., 0] = False
    step = torch.randint(1, n, (L, P, T), generator=gen, device=DEVICE) * switch
    start = torch.randint(0, n, (L, P, 1), generator=gen, device=DEVICE)
    seg = (start + step.cumsum(-1)) % n
    even = (torch.arange(P, device=DEVICE) % 2 == 0)[None, :, None]
    return torch.where(even, seg, iid).to(torch.int32)


def centered_nats(err, family):
    """Largest |error - mean error| over the profiles of one trajectory
    (the last axis), the mean taken within each profile family (labels
    ``family`` along that axis), as bild_tpu's parity ladder centers
    (tools/parity_ladder.py): evidence comparisons do not see a shift that
    every profile of a trajectory shares. NaN entries are left out."""
    out = 0.0
    for f in np.unique(family):
        e = err[..., family == f]
        out = max(out, float(np.nanmax(np.abs(e - np.nanmean(e, axis=-1, keepdims=True)))))
    return out


def held(Tl, got, ref, nan_rows):
    """``(relative error, centered nats or None, within the bars)`` of a
    float32 launch of ``Tl`` frames against its float64 reference: rtol
    `RTOL_F32` per profile, and at T=1000 also `BILD_TPU_CENTERED_T1000`
    for the centered error (`centered_nats`, per lane and per profile
    family: even rows piecewise constant, odd rows i.i.d.)."""
    rel = rel_err(got, ref)
    if Tl < 1000:
        return rel, None, rel <= RTOL_F32
    err = np.where(nan_rows, np.nan, got.astype(float) - ref.astype(float))
    cen = centered_nats(err, np.arange(got.shape[-1]) % 2)
    return rel, cen, rel <= RTOL_F32 and cen <= BILD_TPU_CENTERED_T1000


def lockstep_phase(bt, rng, max_abs):
    """Both kernels at every shape of `LOCKSTEP_SHAPES` (the dataset phase's
    trajectories, config 4's for its shapes, each lane with its own missing
    frames, out-of-range rows in the first and the last lane): against their plain versions (float32, rtol 2e-5 per
    profile) and against their own float64 build on the same data (the bar
    of `held`); NaN exactly on the out-of-range rows. At `CHECKED_SHAPE`: profiles
    permuted within each lane give the permuted results, and 7 chosen
    profiles launched alone and three lanes launched alone (one profile per
    block) give the same bits as in the full launch, so a tile or a block
    shares nothing between profiles. Both kernels are timed at
    `TIMED_SHAPES`, in the order plain, kernel, kernel, plain, and each
    launch's plan is printed. Returns ``({(name, label): (ms, plain_ms,
    bound_ms)}, {(name, label): centered nats against the float64 build
    at T=1000})``."""
    from bild_tpu_torch.ops.kalman_dense import (dense_plan, msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch, sym_plan)

    truths = truth_profiles(np.random.default_rng(3), 128, T, 2)
    profs = np.stack([make_profiles(rng, 128, 2, T) for _ in range(PR6_LANES)])
    valid_all = rng.random((PR6_LANES, T)) > 0.05
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    kernels, data = {}, {}
    for n, loops in ((2, (None, (0, -1))), (3, THREE_STATES)):
        for dtype in (torch.float32, torch.float64):
            model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                              looppositions=loops,
                                              localization_error=0.1,
                                              device=DEVICE, dtype=dtype)
            if dtype == torch.float32:
                data[n] = (model.trajectories_from_loopingprofiles(
                    truths, generator=torch.Generator(device=DEVICE).manual_seed(3)).data
                    if n == 2 else config4_data(model)[2].data)
            ops = model.sym_operators()
            s2, Cind = model._noise_arrays(bt.Trajectory(
                data[n][0], torch.ones(data[n].shape[1], dtype=torch.bool)))
            args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                    model.w, s2, Cind)
            kernels[(n, dtype)] = {
                "kalman_sym": (
                    lambda *a, args=args, ops=ops: msrouse_logL_sym(*args, *a, ops=ops),
                    lambda *a, ops=ops, s2=s2, Cind=Cind: msrouse_logL_sym_torch(ops, s2, Cind, *a)),
                "kalman_dense": (
                    lambda *a, args=args: msrouse_logL_dense(*args, *a),
                    lambda *a, args=args: msrouse_logL_dense_torch(*args, *a)),
            }
    times, drift = {}, {}
    for label, L, P, B, Tl, n in LOCKSTEP_SHAPES:
        rows = torch.arange(L, device=DEVICE) % B
        ydata = data[n][rows].contiguous()
        ydata64 = ydata.double()
        if L <= PR6_LANES and Tl == T:
            valid = torch.as_tensor(valid_all[:L], device=DEVICE)
            prof = torch.as_tensor(profs[:L, :P].copy(), device=DEVICE)
        else:
            valid = torch.rand((L, Tl), generator=gen, device=DEVICE) > 0.05
            prof = lane_profiles(gen, L, P, n, Tl)
        prof[0, P // 2, Tl // 3] = n
        prof[L - 1, P - 1, Tl - 1] = -1
        nan_rows = np.zeros((L, P), dtype=bool)
        nan_rows[0, P // 2] = nan_rows[L - 1, P - 1] = True
        sp = sym_plan(L, P, n, N, DIM, 1, 4)
        dp = dense_plan(L, P, n, N, DIM, 1, 4)
        plans = {"kalman_sym": f"tile {sp.tile}, {sp.blocks} blocks, {sp.smem} B shared",
                 "kalman_dense": (f"{dp.warps} warps per block, {dp.blocks} blocks, "
                                  f"{dp.smem} B shared, operators "
                                  f"{'shared' if dp.ops_shared else 'global'}")}
        for name in ("kalman_sym", "kalman_dense"):
            kern, plain = kernels[(n, torch.float32)][name]
            kern64 = kernels[(n, torch.float64)][name][0]
            got = kern(prof, ydata, valid)
            want = plain(prof, ydata, valid)
            got64 = kern64(prof, ydata64, valid)
            torch.cuda.synchronize()
            got, want, got64 = (x.cpu().numpy() for x in (got, want, got64))
            line = f"{name:12s} lockstep {label:18s} L={L:4d} P={P:3d} T={Tl:4d} n={n}"
            check(got.shape == (L, P), f"{line}: result shape {got.shape}")
            check(np.array_equal(np.isnan(got), np.isnan(want))
                  and np.array_equal(np.isnan(got), np.isnan(got64))
                  and np.array_equal(np.isnan(got), nan_rows),
                  f"{line}: NaN exactly on the out-of-range rows, as the "
                  "plain version and the float64 build")
            e_plain = rel_err(got, want)
            e_f64, c_f64, ok_f64 = held(Tl, got, got64, nan_rows)
            line += (f"  plain rel {e_plain:.2e}  f64 build rel {e_f64:.2e} "
                     f"(rtol {RTOL_F32})")
            if c_f64 is not None:
                # the plain float32 version of the same algorithm, for scale
                c_alg = centered_nats(np.where(nan_rows, np.nan, want - got64),
                                      np.arange(P) % 2)
                drift[(name, label)] = c_f64
                line += (f"  [f64 build: {c_f64:.4f} centered nats per lane and "
                         f"family (bar {BILD_TPU_CENTERED_T1000}, bild_tpu's at "
                         f"T=1000; the plain float32 version {c_alg:.4f})]")
            line += f"  ({plans[name]})"
            check(e_plain <= RTOL_F32, f"{line}: plain within {RTOL_F32}")
            check(ok_f64, f"{line}: f64 build within the bar")
            fin = ~nan_rows
            max_abs[name] = max(max_abs[name], float(
                np.max(np.abs(got[fin] - want[fin]))))
            if label == CHECKED_SHAPE:
                perm = torch.stack([torch.randperm(P, generator=torch.Generator().manual_seed(i))
                                    for i in range(L)]).to(DEVICE)
                permuted = kern(torch.gather(prof, 1, perm[..., None].expand(-1, -1, Tl))
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
            if label in TIMED_SHAPES:
                p1 = time_ms(lambda: plain(prof, ydata, valid), 1)
                k1, k2 = (time_ms(lambda: kern(prof, ydata, valid), 2)
                          for _ in range(2))
                p2 = time_ms(lambda: plain(prof, ydata, valid), 1)
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                observed = int(valid.sum())
                flops, nbytes = kernel_work(L, P, Tl, n, N, DIM, 1, observed)
                bnd, by = bound_ms(flops, nbytes)
                own = algorithm_flops(name, L, P, Tl, N, DIM, 1, observed)
                times[(name, label)] = (ms, plain_ms, bnd)
                print(f"time {name:12s} {label} L={L} P={P} T={Tl} n={n}  kernel "
                      f"{ms:9.3f} ms ({L * P / ms * 1e3:12.1f} profiles/s)  "
                      f"plain {plain_ms:9.3f} ms "
                      f"({L * P / plain_ms * 1e3:12.1f} profiles/s)  bound "
                      f"{bnd:.3f} ms ({by}: {flops / 1e9:.1f} GFLOP, "
                      f"{nbytes / 1e6:.1f} MB), {bnd / ms:.1%} of bound; its "
                      f"own algorithm {own / 1e9:.1f} GFLOP, "
                      f"{own / ms / 1e9:.2f} TFLOP/s", flush=True)
        del prof, ydata, ydata64, valid
    return times, drift


# The shapes of PERF.md's kernel table, where the parent commit's float32
# likelihood kernels are timed beside this checkout's: (label, L, P, T,
# states)
PARENT_SHAPES = (("sample() step", 1, 100, 100, 2), ("bench", 1, 8192, 100, 2),
                 ("config 3 lockstep", 640, 128, 100, 2),
                 ("config 4 scout", 112, 128, 1000, 3),
                 ("config 5 scout", 5120, 128, 100, 2))
# The parent's results against this checkout's on the same inputs: the
# same arithmetic (the tile plan's code is the parent's; the cluster plan
# gives its bits), so the same bits at every shape.


def parent_kernel_phase(bt, parent, ptxas):
    """``nvcc -Xptxas -v`` of both likelihood kernels (registers, stack
    frame and spills of every instantiation), then, with the parent's
    kernels (`build_parent`), both float32 kernels against the parent's at
    `PARENT_SHAPES` (the README model's two states, or config 4's three;
    trajectories drawn by the model, profiles by `lane_profiles`, about 5 %
    of the frames missing): the parent launched through its C entry point
    with its own plan (the tile plan of `sym_plan`, `dense_plan`) and the
    wrapper's NaN mask, bit for bit equal to this checkout's kernel with
    its plan (at sample()'s step the sym kernel's cluster plan); CUDA
    events in turns (parent, change, change, parent), beside the computed
    bound, and at sample()'s step this checkout's sym launch forced onto
    the tile plan too (parent, change, tile, tile, change, parent).
    Returns ``{(name, label): (ms, parent_ms, bound_ms)}`` and, for sym at
    sample()'s step, ``("kalman_sym tile", label)``: the forced tile
    plan's ``(ms, parent_ms, bound_ms)`` (empty without the parent's
    kernels)."""
    from bild_tpu_torch.ops.kalman import in_range_mask
    from bild_tpu_torch.ops.kalman_dense import (cind_tensor, dense_plan,
                                                 msrouse_logL_dense, sm_count)
    from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym, sym_plan

    names = ("kalman_sym", "kalman_dense")
    for name in names:
        for kernel, (regs, frame, st, ld) in sorted(ptxas[name].items()):
            print(f"ptxas {name} {kernel}: {regs} registers, {frame} bytes stack "
                  f"frame, {st} / {ld} bytes spill stores / loads", flush=True)
    if not all(name in parent for name in names):
        print("parent likelihood kernels: none", flush=True)
        return {}
    fns = {name: parent_entry(parent[name], name, torch.float32) for name in names}
    sms = sm_count(0)
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    out = {}
    for label, L, P, Tl, n in PARENT_SHAPES:
        loops = THREE_STATES if n == 3 else (None, (0, -1))
        model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM, looppositions=loops,
                                          localization_error=0.1, device=DEVICE,
                                          dtype=torch.float32)
        B = min(L, 128)
        data = model.trajectories_from_loopingprofiles(
            truth_profiles(np.random.default_rng(3), B, Tl, n),
            generator=torch.Generator(device=DEVICE).manual_seed(3)).data
        ydata = data[torch.arange(L, device=DEVICE) % B].contiguous()
        valid = torch.rand((L, Tl), generator=gen, device=DEVICE) > 0.05
        prof = lane_profiles(gen, L, P, n, Tl)
        s2, Cind = model._noise_arrays(bt.Trajectory(ydata[0], valid[0]))
        Cind = cind_tensor(Cind, DIM, ydata.device)
        ops = model.sym_operators()
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                s2, Cind, prof, ydata, valid)
        sp = sym_plan(L, P, n, N, DIM, 1, 4, sms=sms, _force="tile")
        dp = dense_plan(L, P, n, N, DIM, 1, 4, sms=sms)
        stream = torch.cuda.current_stream().cuda_stream

        def masked(launch):
            res = torch.empty((L, P), dtype=torch.float32, device=DEVICE)
            check(launch(res) == 0, f"the parent's kernel launches at {label}")
            return torch.where(in_range_mask(prof, n), res, torch.full_like(res, math.nan))

        runs = {
            "kalman_sym": (
                lambda: msrouse_logL_sym(*args, ops=ops, matmul="exact"),
                lambda: masked(lambda res: fns["kalman_sym"](
                    ops.Pslab.data_ptr(), ops.sig.data_ptr(), ops.c0.data_ptr(),
                    model.w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
                    ops.M0w.data_ptr(), s2.data_ptr(), Cind.data_ptr(),
                    prof.data_ptr(), ydata.data_ptr(), valid.data_ptr(),
                    res.data_ptr(), n, N, DIM, 1, L, P, Tl, ops.PPp, ops.N1p,
                    sp.tile, sp.smem, 0, stream)),
                ("cluster plan" if label == "sample() step" else f"tile {sp.tile}")
                + f" [parent tile {sp.tile}]"),
            "kalman_dense": (
                lambda: msrouse_logL_dense(*args),
                lambda: masked(lambda res: fns["kalman_dense"](
                    model.Bs.data_ptr(), model.Gs.data_ptr(), model.Sigs.data_ptr(),
                    model.M0s.data_ptr(), model.C0s.data_ptr(), model.w.data_ptr(),
                    s2.data_ptr(), Cind.data_ptr(), prof.data_ptr(),
                    ydata.data_ptr(), valid.data_ptr(), res.data_ptr(), n, N, DIM,
                    1, L, P, Tl, dp.warps, int(dp.ops_shared), dp.smem, 0, stream)),
                f"{dp.warps} warps [parent {dp.warps}]"),
        }
        reps = max(1, min(20, int(2e4 // (L * P * Tl / 1e3))))
        bnd, by = bound_ms(*kernel_work(L, P, Tl, n, N, DIM, 1, int(valid.sum())))
        for name, (kern, old, plan) in runs.items():
            got, was = kern(), old()
            torch.cuda.synchronize()
            got, was = got.cpu().numpy(), was.cpu().numpy()
            same = np.array_equal(got, was, equal_nan=True)
            line = (f"parent {name:12s} {label:17s} L={L:4d} P={P:4d} T={Tl:4d} "
                    f"n={n}: this checkout against the parent's kernel: "
                    f"{'same bits' if same else f'DIFFER (rel {rel_err(got, was):.2e})'}")
            check(same, f"{line}: the parent's bits")
            tile = (lambda: msrouse_logL_sym(*args, ops=ops, _force="tile")) \
                if (name, label) == ("kalman_sym", "sample() step") else None
            order = (old, kern, kern, old) if tile is None else (old, kern, tile, tile,
                                                                 kern, old)
            t = [time_ms(f, reps) for f in order]
            ms, parent_ms = (t[1] + t[-2]) / 2, (t[0] + t[-1]) / 2
            out[(name, label)] = (ms, parent_ms, bnd)
            if tile is not None:
                check(np.array_equal(tile().cpu().numpy(), was, equal_nan=True),
                      f"{line}: the tile plan gives the parent's bits")
                out[("kalman_sym tile", label)] = ((t[2] + t[3]) / 2, parent_ms, bnd)
                line += f"; this checkout's tile plan {(t[2] + t[3]) / 2:.3f} ms"
            print(f"{line}; {plan}; parent {parent_ms:.3f} ms ({bnd / parent_ms:.2%} "
                  f"of bound), change {ms:.3f} ms ({bnd / ms:.2%}), "
                  f"{ms / parent_ms:.2f}x; bound {bnd:.4f} ms ({by})", flush=True)
        del prof, ydata, valid
    return out


# (frames, states) of the parity ladder (tools/parity_ladder.py's shapes:
# configs 2/3/5, a T=300 probe, config 4), and bild_tpu's sym exact tier on
# a TPU v5e against the float64 oracle there (BASELINE.md:59-67): max
# relative error (None: not recorded), max nats, max centered nats
LADDER = ((100, 2, (1.3e-5, 0.006, 0.004)),
          (300, 2, (None, 0.017, 0.014)),
          (1000, 3, (1.5e-5, 0.15, 0.11)))
LADDER_PROFILES = 64
LADDER_ORACLE = 4


def ladder_case(bt, Tl, n):
    """One rung of `LADDER`: the float32 and float64 models (N=20, d=3; n
    states), one trajectory drawn on the card with a loop over the middle
    third (as tools/parity_ladder.py draws it) and three profile families
    (64 every-frame random, 64 segment profiles with 0-6 switches, the n
    constant ones). Returns ``(models, traj, families, prof, fam_of)``:
    ``prof`` the families stacked (int32), ``fam_of`` each row's family."""
    loops = THREE_STATES if n == 3 else (None, (0, -1))
    rng = np.random.default_rng(2)
    models = {dtype: bt.models.MultiStateRouse(
        N, D, KSPRING, d=DIM, looppositions=loops, localization_error=0.1,
        device=DEVICE, dtype=dtype) for dtype in (torch.float32, torch.float64)}
    truth = np.zeros(Tl, dtype=int)
    truth[3 * Tl // 10: 6 * Tl // 10] = 1
    traj = models[torch.float32].trajectory_from_loopingprofile(
        truth, generator=torch.Generator(device=DEVICE).manual_seed(42))
    families = {
        "random": rng.integers(0, n, size=(LADDER_PROFILES, Tl)),
        "segment": truth_profiles(rng, LADDER_PROFILES, Tl, n, k_max=6),
        "constant": np.repeat(np.arange(n)[:, None], Tl, axis=1),
    }
    prof = np.concatenate(list(families.values())).astype(np.int32)
    fam_of = np.repeat(np.arange(3), [len(f) for f in families.values()])
    return models, traj, families, prof, fam_of


def ladder_phase(bt):
    """The parity ladder: both float32 kernels against their own float64
    build on one trajectory per shape of `LADDER` (`ladder_case`), in three
    profile families, as one single-lane launch. Prints
    the max relative error, the max absolute nats and the max centered nats
    (each profile's error minus the mean error: over the whole shape, and
    over each family as bild_tpu's ladder centers) beside bild_tpu's TPU
    numbers. `LADDER_ORACLE` profiles per shape also against the numpy
    float64 oracle: the float64 build within 1e-9. Bars for float32: rtol
    2e-5, and at T=1000 also `BILD_TPU_CENTERED_T1000` centered per family
    (as `held`). Returns
    ``{(name, T): (max rel, max nats, max centered nats, centered nats per
    family)}``."""
    from bild_tpu_torch.ops.kalman_dense import msrouse_logL_dense
    from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym
    from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

    out = {}
    for Tl, n, tpu in LADDER:
        models, traj, families, prof, fam_of = ladder_case(bt, Tl, n)
        prof_t = torch.as_tensor(prof, device=DEVICE)
        vals = {}
        for dtype, model in models.items():
            s2, Cind = model._noise_arrays(traj)
            args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                    model.w, s2, Cind, prof_t, traj.data.to(dtype), traj.valid)
            vals[("kalman_sym", dtype)] = msrouse_logL_sym(
                *args, ops=model.sym_operators())
            vals[("kalman_dense", dtype)] = msrouse_logL_dense(*args)
        torch.cuda.synchronize()
        vals = {k: v.cpu().numpy().astype(float) for k, v in vals.items()}
        h = models[torch.float64].host
        picks = [0, LADDER_PROFILES, LADDER_PROFILES + 1, 2 * LADDER_PROFILES]
        oracle = np.array([msrouse_logL_numpy(
            h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"],
            np.asarray(models[torch.float64]._get_noise(traj)), prof[p], traj[:])
            for p in picks[:LADDER_ORACLE]])
        for name in ("kalman_sym", "kalman_dense"):
            f32, f64 = vals[(name, torch.float32)], vals[(name, torch.float64)]
            check(np.all(np.isfinite(f32)) and np.all(np.isfinite(f64)),
                  f"ladder {name} T={Tl}: finite")
            err = f32 - f64
            rel = float(np.max(np.abs(err / f64)))
            nats = float(np.max(np.abs(err)))
            cen = float(np.max(np.abs(err - err.mean())))
            cen_fams = [centered_nats(err[fam_of == i], fam_of[fam_of == i])
                        for i in range(3)]
            e64 = rel_err(f64[picks], oracle)
            e32 = rel_err(f32[picks], oracle)
            rel_tpu = "not recorded" if tpu[0] is None else f"{tpu[0]:.1e}"
            line = (f"ladder {name:12s} T={Tl:4d} n={n} ({len(prof)} profiles): "
                    f"float32 against its float64 build: max rel {rel:.2e}, max "
                    f"{nats:.4f} nats, max centered {cen:.4f} nats over the "
                    f"shape ({' / '.join(f'{c:.4f}' for c in cen_fams)} within "
                    f"the {' / '.join(families)} family); against the float64 "
                    f"oracle ({len(picks)} profiles): float32 {e32:.2e}, float64 "
                    f"build {e64:.2e}; bild_tpu sym exact on a TPU v5e against "
                    f"the oracle: max rel {rel_tpu}, {tpu[1]} nats, "
                    f"{tpu[2]} centered")
            print(line, flush=True)
            check(e64 <= RTOL_F64, f"{line}: float64 build within {RTOL_F64} of the oracle")
            check(rel <= RTOL_F32, f"{line}: float32 within rtol {RTOL_F32}")
            if Tl >= 1000:
                check(max(cen_fams) <= BILD_TPU_CENTERED_T1000,
                      f"{line}: float32 within {BILD_TPU_CENTERED_T1000} "
                      "centered nats per family")
            out[(name, Tl)] = (rel, nats, cen, cen_fams)
    return out


# The split tiers of the packed kernel (bild_tpu's split_bf16 / split_update
# flags; `config.set_rouse_matmul`), checked by `split_phase`. Every bar was
# written into PERF.md section 2 before the phase first ran on the card.
SPLIT_TIERS = ("split_cov", "split")
# The kernel against its plain split version at T=100: rtol 1e-4, the
# tier's own floor on a TPU v5e (bild_tpu's sym split, 8.8e-5 against the
# oracle, BASELINE.md:59-67), for 'split_cov'. 'split' rounds every
# covariance slot to its bf16 pair before the update contraction, so two
# float32 implementations that sum the conjugation in another order differ
# by the tier's own error (tests/test_torch_matmul_tiers.py): it is held
# to twice its plain version's own error against the float64 build on the
# same launch (then the kernel is no less accurate than its plain
# version), and to 1e-4 where that is larger. Neither bar tells a tier
# from another at T=100; the two-frame checks below do.
RTOL_SPLIT = 1e-4
# The tiers told apart: every lockstep shape cut, for each split tier, to
# the shortest length where its split acts on inputs that the kernel and
# its plain version hold bit for bit (SPLIT_SHORT_T): 'split' at one frame
# (its update contraction of the host's c0), 'split_cov' at two (its
# conjugation of the first update's output, which feeds an exact update).
# (a) The kernel against its plain version within RTOL_SPLIT_SHORT
# (relative to max(|logL|, 1 nat)), and the plain tier at least twice
# that far from what a skipped split computes ('split': the exact tier;
# 'split_cov': 'split'); (b) the kernel's shift from its exact tier,
# k_tier - k_exact, against the plain shift, p_tier - p_exact: the
# least-squares slope of one on the other within SPLIT_SLOPE (a kernel
# without the split has no shift). 'split' at two frames is printed with
# no bar: its update contraction rounds the conjugation's output to bf16
# pairs, and one bf16 ulp in the low half of a slot moves it by more than
# its whole shift (PERF.md section 2). The CPU tests hold the plain tiers
# to the same bars against bild_tpu's interpret kernel
# (tests/test_torch_matmul_tiers.py::test_short_split_tiers_*).
SPLIT_SHORT_T = {"split": 1, "split_cov": 2}
RTOL_SPLIT_SHORT = 1e-6
SPLIT_SLOPE = (0.5, 2.0)
# the ladder's T=100 bars against the float64 build (max rel, centered
# nats per profile family): 'split_cov' must meet them. For 'split' they
# are the gate of the default: `config.rouse_matmul()` may be bild_tpu's
# 'auto' only if 'split' meets them and config 3 under 'auto' is no slower
# than under 'exact' (split_phase's in-call comparison); T=300 and 1000
# are read without a bar ('auto' never splits there).
SPLIT_LADDER_T100 = (1e-4, 0.1)
# bild_tpu's split tiers on a TPU v5e against the float64 oracle
# (BASELINE.md:59-67): (max rel or None where not recorded, max centered
# nats)
BILD_TPU_SPLIT = {("split", 100): (8.8e-5, 0.085), ("split", 300): (None, 0.52),
                  ("split", 1000): (5.8e-4, 4.5), ("split_cov", 1000): (None, 0.81)}
# The dataset run's lockstep launches (per 64-trajectory chunk: scout,
# refine, the boundary climb; config 3 in one chunk), and the launches
# timed: the AMIS step of sample(), config 3 in one chunk, config 5's scout
SPLIT_SHAPES = (("chunk scout", 320, 128), ("chunk refine", 192, 128),
                ("boundary climb", 64, 9), ("one chunk of 128", 640, 128))
SPLIT_TIMED = ((1, 100), (640, 128), (5120, 128))


def rel_err_floor(got, want):
    """Largest relative error over the finite reference rows, each row
    relative to max(|want|, 1 nat) (two-frame likelihoods can be near 0)."""
    fin = np.isfinite(want)
    return float(np.max(np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0)))


def shift_slope(got, want):
    """The least-squares slope of shift ``got`` on shift ``want`` (both
    over the finite rows of ``want``)."""
    fin = np.isfinite(want)
    got, want = got[fin], want[fin]
    return float(got @ want / (want @ want))


# The split kernel's probe build (csrc/kalman_sym_split.cu with
# PROBE_DEFINE): the first tile of a lockstep launch writes what frame 1's
# update contraction and mean propagation read and wrote. The plain
# version's steps (ops/kalman_sym.py::update_contraction,
# mean_propagation) applied to those same input bits differ from the
# kernel's outputs by float32 summation order only: each quantity within
# PROBE_RTOL of its largest entry (the plain steps with their sums taken in
# float64 move by at most 1.05e-7 on the CPU). The steps without the split
# (Cw rows exact, means exact) land at least 1.6e-6 away there, so a
# kernel is also held at least 2 x PROBE_RTOL from the other variant:
# 'split' must split Cw and the means, 'split_cov' must not
# (tests/test_torch_matmul_tiers.py::test_split_probe_bar_tells_the_splits_apart).
PROBE_RTOL = 4e-7
PROBE_DEFINE = "BILD_SPLIT_PROBE"


def split_probe(tier, ops, w, s2, Cind, prof, ydata, valid):
    """Frame 1's update contraction and mean propagation of the split
    kernel's first tile (its probe build) against the plain steps on the
    kernel's own inputs; frames 0 and 1 are observed. Returns the line."""
    import ctypes
    from bild_tpu_torch.ops import _build
    from bild_tpu_torch.ops.kalman_dense import cind_tensor
    from bild_tpu_torch.ops.kalman_sym import (mean_propagation, sym_plan,
                                               update_contraction)
    lib = _build.load("kalman_sym_split", (PROBE_DEFINE,))
    fn = getattr(lib, "bild_kalman_sym_split_f32" if tier == "split"
                 else "bild_kalman_sym_splitcov_f32")
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    lib.bild_split_probe_set.argtypes = [ctypes.c_void_p]
    L, P, T = prof.shape
    n, N, d, q = ops.n, ops.N, ydata.shape[2], s2.shape[0]
    PP, N1 = N * (N + 1) // 2, N + 1
    plan = sym_plan(L, P, n, N, d, q, 4, tier=tier)
    tp = min(plan.tile, P)
    ncol = tp * q
    buf = torch.full((ncol * (PP + N + 1) + 2 * tp * N1 * d,), math.nan, device=DEVICE)
    check(lib.bild_split_probe_set(buf.data_ptr()) == 0, "probe buffer set")
    valid = valid.clone()
    valid[:, :2] = True
    cind = cind_tensor(Cind, d, ydata.device)
    out = torch.empty((L, P), device=DEVICE)
    rc = fn(ops.Psplit.data_ptr(), ops.Srow.data_ptr(), ops.sig.data_ptr(),
            ops.c0.data_ptr(), w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
            ops.M0w.data_ptr(), s2.data_ptr(), cind.data_ptr(), prof.data_ptr(),
            ydata.data_ptr(), valid.data_ptr(), out.data_ptr(), n, N, d, q, L, P, T,
            ops.PPp, ops.N1p, plan.tile, plan.stages, plan.smem, ydata.device.index or 0,
            torch.cuda.current_stream().cuda_stream)
    check(rc == 0, f"probe launch of {tier} (rc {rc})")
    torch.cuda.synchronize()
    parts = torch.split(buf, [ncol * PP, ncol * N, ncol, tp * N1 * d, tp * N1 * d])
    c = torch.zeros((tp, q, ops.PPp), device=DEVICE)
    c[..., :PP] = parts[0].view(tp, q, PP)
    got = {"Cw": parts[1].view(tp, q, N), "1/S": parts[2].view(tp, q),
           "Mn": parts[4].view(tp, N1, d)}
    M = parts[3].view(tp, N1, d)
    check(bool(torch.isfinite(c).all() and torch.isfinite(M).all()) and bool(M.abs().max() > 0),
          f"probe {tier}: the kernel wrote its inputs")
    st = prof[0, :tp, 1].long().clamp(0, n - 1)

    def steps(split):
        Cw, Sinv = update_contraction(ops, c, s2, split)
        return {"Cw": Cw, "1/S": Sinv, "Mn": mean_propagation(ops, M, st, split)[:, :N1]}

    def r(a, b):
        return float((a - b).abs().max() / b.abs().max())

    own, other = steps(tier == "split"), steps(tier != "split")
    e = {k: r(got[k], own[k]) for k in got}
    sep = {k: r(got[k], other[k]) for k in got}
    line = (f"split {tier:9s} probe, frame 1 of tile 0 at L={L} P={P}: kernel against its "
            f"plain steps on the same inputs " + ", ".join(f"{k} {v:.2e}" for k, v in e.items())
            + f" (bar {PROBE_RTOL:.0e}); from the {'exact' if tier == 'split' else 'split'} "
            f"steps " + ", ".join(f"{k} {v:.2e}" for k, v in sep.items())
            + f" (Cw, Mn at least {2 * PROBE_RTOL:.0e})")
    check(max(e.values()) <= PROBE_RTOL, f"{line}: kernel within its bar")
    check(min(sep["Cw"], sep["Mn"]) >= 2 * PROBE_RTOL, f"{line}: the tier's own split")
    return line


def split_bar(tier, plain_f64):
    """The kernel-against-plain bar of ``tier`` (see `RTOL_SPLIT`), given
    the plain split version's max relative error against the float64
    build on the same launch."""
    return RTOL_SPLIT if tier == "split_cov" else max(RTOL_SPLIT, 2 * plain_f64)


def split_phase(bt, rng):
    """The split tiers on the card: for 'split_cov' and 'split',
    the tensor-core kernel against its plain split version at
    `kernel_cases()` and at `SPLIT_SHAPES` (NaN rows, missing frames; bars
    `split_bar`), with the float64 build beside it, and at `SPLIT_SHAPES`
    cut to `SPLIT_SHORT_T` frames (`hold_short`: `RTOL_SPLIT_SHORT`,
    `SPLIT_SLOPE`); at L=640 permuted
    profiles, 7 profiles alone and lanes alone give the same bits; the
    ladder at T=100, 300 and 1000 (`ladder_case`) against the float64
    build beside bild_tpu's TPU readings (bars `SPLIT_LADDER_T100`);
    CUDA-event times of exact, split_cov and split at `SPLIT_TIMED`
    beside `split_bound_ms`; and config 3's lockstep `sample_dataset`
    (tools/ab_dataset.py's settings) under 'exact' and 'auto' in one call:
    wall, busy share, accuracy against the dataset bars, the split
    launches of the 'auto' runs. Checks the default against its gate.
    Returns ``{"launches", "max_abs", "times", "default"}``."""
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch, sym_plan)
    from bild_tpu_torch.parallel import sample_dataset

    t_phase = time.perf_counter()
    default = bt.config.rouse_matmul()
    max_abs = 0.0

    def hold_split(label, tier, got, plain, f64, nan_rows):
        """Check one split launch against its plain version; returns the
        printed readings."""
        nonlocal max_abs
        got, plain, f64 = (x.cpu().numpy().astype(float) for x in (got, plain, f64))
        check(np.array_equal(np.isnan(got), nan_rows)
              and np.array_equal(np.isnan(plain), nan_rows),
              f"split {tier} {label}: NaN exactly on the out-of-range rows")
        check(np.all(np.isfinite(got[~nan_rows])), f"split {tier} {label}: finite")
        e_plain, e_p64, e_k64 = (rel_err(got, plain), rel_err(plain, f64),
                                 rel_err(got, f64))
        bar = split_bar(tier, e_p64)
        max_abs = max(max_abs, float(np.max(np.abs(got - plain)[~nan_rows])))
        line = (f"split {tier:9s} {label:44s} kernel against plain rel "
                f"{e_plain:.2e} (bar {bar:.2e}); against the float64 build: "
                f"kernel {e_k64:.2e}, plain {e_p64:.2e}")
        check(e_plain <= bar, f"{line}: kernel within its bar of the plain version")
        return line

    # -- the kernel against its plain version: sample()'s launches ---------
    for label, loops, err, P, missing, bad_rows in kernel_cases():
        n = len(loops)
        models = {dt: bt.models.MultiStateRouse(
            N, D, KSPRING, d=DIM, looppositions=loops, localization_error=err,
            device=DEVICE, dtype=dt) for dt in (torch.float32, torch.float64)}
        true = np.zeros(T, dtype=int)
        true[30:60] = 1
        traj = models[torch.float32].trajectory_from_loopingprofile(
            true, missing_frames=np.asarray(missing, dtype=int),
            generator=torch.Generator(device=DEVICE).manual_seed(P))
        prof = make_profiles(rng, P, n, T)
        for r, bad in zip(bad_rows, (n, -1)):
            prof[r, T // 2] = bad
        nan_rows = np.zeros(P, dtype=bool)
        nan_rows[list(bad_rows)] = True
        args = {}
        for dt, m in models.items():
            s2, Cind = m._noise_arrays(traj)
            args[dt] = (m.Bs, m.Gs, m.Sigs, m.M0s, m.C0s, m.w, s2, Cind,
                        torch.as_tensor(prof, device=DEVICE), traj.data.to(dt),
                        traj.valid)
        ops = models[torch.float32].sym_operators()
        f64 = msrouse_logL_sym(*args[torch.float64],
                               ops=models[torch.float64].sym_operators())
        for tier in SPLIT_TIERS:
            got = msrouse_logL_sym(*args[torch.float32], ops=ops, matmul=tier)
            plain = msrouse_logL_sym_torch(ops, *args[torch.float32][6:],
                                           matmul=tier)
            torch.cuda.synchronize()
            print(hold_split(label, tier, got, plain, f64, nan_rows), flush=True)

    # -- the lockstep launches, and bit equality at L=640 -------------------
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1, device=DEVICE)
    model64 = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                        localization_error=0.1, device=DEVICE,
                                        dtype=torch.float64)
    truths, true_k, batch, trajs = config3_data(model, T=T)
    s2, Cind = model._noise_arrays(trajs[0])
    margs = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2, Cind)
    margs64 = (model64.Bs, model64.Gs, model64.Sigs, model64.M0s, model64.C0s,
               model64.w, s2.double(), Cind)
    ops, ops64 = model.sym_operators(), model64.sym_operators()
    gen = torch.Generator(device=DEVICE).manual_seed(9)

    def lanes(L, P):
        rows = torch.arange(L, device=DEVICE) % batch.B
        prof = lane_profiles(gen, L, P, 2, T)
        prof[0, P // 2, T // 3] = 2
        prof[L - 1, P - 1, T - 1] = -1
        valid = torch.rand((L, T), generator=gen, device=DEVICE) > 0.05
        nan_rows = np.zeros((L, P), dtype=bool)
        nan_rows[0, P // 2] = nan_rows[L - 1, P - 1] = True
        return prof, batch.data[rows].contiguous(), valid, nan_rows

    def hold_short(label, L, P, prof, ydata, valid):
        """The short-length checks (`SPLIT_SHORT_T`) of one lockstep shape,
        on the first frames of its launch, the out-of-range rows moved
        there."""
        for TS in (1, 2):
            sprof = prof[..., :TS].clone()
            sprof[0, P // 2, TS - 1] = 2
            sprof[L - 1, P - 1, 0] = -1
            nan_rows = np.zeros((L, P), dtype=bool)
            nan_rows[0, P // 2] = nan_rows[L - 1, P - 1] = True
            sy = ydata[:, :TS].contiguous()
            sv = valid[:, :TS].clone()
            sv[:, 0] = True             # frame 0 seen: no lane's logL is 0
            k, p = {}, {}
            for tier in ("exact",) + SPLIT_TIERS:
                k[tier] = msrouse_logL_sym(*margs, sprof, sy, sv, ops=ops, matmul=tier)
                p[tier] = msrouse_logL_sym_torch(ops, s2, Cind, sprof, sy, sv,
                                                 matmul=tier)
            torch.cuda.synchronize()
            k = {t: v.cpu().numpy().astype(float) for t, v in k.items()}
            p = {t: v.cpu().numpy().astype(float) for t, v in p.items()}
            for tier in SPLIT_TIERS:
                check(np.array_equal(np.isnan(k[tier]), nan_rows)
                      and np.array_equal(np.isnan(p[tier]), nan_rows),
                      f"split {tier} T={TS} {label}: NaN exactly on the out-of-range rows")
                e = rel_err_floor(k[tier], p[tier])
                line = (f"split {tier:9s} T={TS} lockstep {label} L={L} P={P}: "
                        f"kernel against plain {e:.2e}")
                if TS != SPLIT_SHORT_T[tier]:   # 'split_cov' splits nothing at T=1
                    if tier == "split":
                        print(f"{line} (no bar: the update contraction rounds the "
                              f"conjugation's output to bf16 pairs)", flush=True)
                    continue
                near = "exact" if tier == "split" else "split"
                sep = rel_err_floor(p[tier], p[near])
                slope = shift_slope(k[tier] - k["exact"], p[tier] - p["exact"])
                line += (f" (bar {RTOL_SPLIT_SHORT:.0e}); plain {tier} from plain "
                         f"{near} {sep:.2e} (at least {2 * RTOL_SPLIT_SHORT:.0e}); "
                         f"shift from exact, kernel on plain: slope {slope:.3f} "
                         f"(within {SPLIT_SLOPE})")
                print(line, flush=True)
                check(e <= RTOL_SPLIT_SHORT, f"{line}: kernel within its bar")
                check(sep >= 2 * RTOL_SPLIT_SHORT, f"{line}: the bar tells the tiers apart")
                check(SPLIT_SLOPE[0] <= slope <= SPLIT_SLOPE[1],
                      f"{line}: the kernel shifts as its plain version does")

    for label, L, P in SPLIT_SHAPES:
        prof, ydata, valid, nan_rows = lanes(L, P)
        f64 = msrouse_logL_sym(*margs64, prof, ydata.double(), valid, ops=ops64)
        for tier in SPLIT_TIERS:
            kern = functools.partial(msrouse_logL_sym, *margs, ops=ops, matmul=tier)
            got = kern(prof, ydata, valid)
            plain = msrouse_logL_sym_torch(ops, s2, Cind, prof, ydata, valid,
                                           matmul=tier)
            torch.cuda.synchronize()
            sp = sym_plan(L, P, 2, N, DIM, 1, 4, tier=tier)
            line = hold_split(f"lockstep {label} L={L} P={P}", tier, got, plain,
                              f64, nan_rows) + f" (tile {sp.tile}, {sp.blocks} blocks, {sp.smem} B shared)"
            if label == CHECKED_SHAPE:
                got = got.cpu().numpy()
                perm = torch.stack([torch.randperm(P, generator=torch.Generator().manual_seed(i))
                                    for i in range(L)]).to(DEVICE)
                permuted = kern(torch.gather(prof, 1, perm[..., None].expand(-1, -1, T))
                                .contiguous(), ydata, valid)
                chosen = torch.as_tensor([0, 5, 17, P // 2, 90, P - 2, P - 1], device=DEVICE)
                alone = kern(prof[:, chosen].contiguous(), ydata, valid)
                picks = (0, L // 2, L - 1)
                singles = [kern(prof[i], ydata[i], valid[i]) for i in picks]
                torch.cuda.synchronize()
                same = (np.array_equal(permuted.cpu().numpy(),
                                       np.take_along_axis(got, perm.cpu().numpy(), 1),
                                       equal_nan=True),
                        np.array_equal(alone.cpu().numpy(), got[:, chosen.cpu().numpy()],
                                       equal_nan=True),
                        all(np.array_equal(one.cpu().numpy(), got[i], equal_nan=True)
                            for i, one in zip(picks, singles)))
                line += (f"  permuted within lanes: {'same bits' if same[0] else 'DIFFER'}"
                         f"  7 profiles alone: {'same bits' if same[1] else 'DIFFER'}"
                         f"  lanes alone: {'same bits' if same[2] else 'DIFFER'}")
                check(all(same), f"{line}: the same bits in every launch shape")
            print(line, flush=True)
        hold_short(label, L, P, prof, ydata, valid)
        for tier in SPLIT_TIERS:
            print(split_probe(tier, ops, model.w, s2, Cind, prof.clamp(0, 1).contiguous(),
                              ydata, valid), flush=True)
        del prof, ydata, valid, f64

    # -- the ladder ----------------------------------------------------------
    ladder_ok = {}
    for Tl, n, _ in LADDER:
        models, traj, families, prof, fam_of = ladder_case(bt, Tl, n)
        prof_t = torch.as_tensor(prof, device=DEVICE)
        vals = {}
        for dtype, m in models.items():
            s2l, Cl = m._noise_arrays(traj)
            a = (m.Bs, m.Gs, m.Sigs, m.M0s, m.C0s, m.w, s2l, Cl, prof_t,
                 traj.data.to(dtype), traj.valid)
            if dtype == torch.float64:
                vals["f64"] = msrouse_logL_sym(*a, ops=m.sym_operators())
                continue
            for tier in SPLIT_TIERS:
                vals[tier] = msrouse_logL_sym(*a, ops=m.sym_operators(), matmul=tier)
                vals[f"plain {tier}"] = msrouse_logL_sym_torch(
                    m.sym_operators(), *a[6:], matmul=tier)
        torch.cuda.synchronize()
        vals = {k: v.cpu().numpy().astype(float) for k, v in vals.items()}
        for tier in SPLIT_TIERS:
            read = {}
            for who in (tier, f"plain {tier}"):
                check(np.all(np.isfinite(vals[who])), f"ladder {who} T={Tl}: finite")
                err = vals[who] - vals["f64"]
                read[who] = (float(np.max(np.abs(err / vals["f64"]))),
                             [centered_nats(err[fam_of == i], fam_of[fam_of == i])
                              for i in range(3)])
            rel, cen = read[tier]
            tpu = BILD_TPU_SPLIT.get((tier, Tl))
            tpu = ("not recorded" if tpu is None else
                   f"max rel {'not recorded' if tpu[0] is None else f'{tpu[0]:.1e}'}, "
                   f"{tpu[1]} centered")
            line = (f"ladder split {tier:9s} T={Tl:4d} n={n} ({len(prof)} profiles): "
                    f"kernel against the float64 build: max rel {rel:.2e}, "
                    f"centered {' / '.join(f'{c:.4f}' for c in cen)} nats "
                    f"({' / '.join(families)}); plain {tier} "
                    f"{read[f'plain {tier}'][0]:.2e}, "
                    f"{' / '.join(f'{c:.4f}' for c in read[f'plain {tier}'][1])}; "
                    f"bild_tpu {tier} on a TPU v5e against the oracle: {tpu}")
            if Tl == 100:
                ladder_ok[tier] = (rel <= SPLIT_LADDER_T100[0]
                                   and max(cen) <= SPLIT_LADDER_T100[1])
                line += (f"  [T=100 bars {SPLIT_LADDER_T100[0]} / "
                         f"{SPLIT_LADDER_T100[1]} nats: "
                         f"{'met' if ladder_ok[tier] else 'MISSED'}]")
            print(line, flush=True)
    check(ladder_ok["split_cov"], "ladder split_cov at T=100 within its bars")

    # -- times ---------------------------------------------------------------
    times = {}
    for L, P in SPLIT_TIMED:
        if L == 1:
            prof = torch.as_tensor(make_profiles(rng, P, 2, T), device=DEVICE)
            ydata, valid = batch.data[0], batch.valid[0]
        else:
            prof, ydata, valid, _ = lanes(L, P)
            prof = prof.clamp(0, 1)
        fns = {tier: functools.partial(msrouse_logL_sym, *margs, prof, ydata,
                                       valid, ops=ops, matmul=tier)
               for tier in ("exact",) + SPLIT_TIERS}
        reps = 20 if L == 1 else 2
        order = ("exact",) + SPLIT_TIERS + SPLIT_TIERS[::-1] + ("exact",)
        ms = {tier: [] for tier in fns}
        for tier in order:
            ms[tier].append(time_ms(fns[tier], reps))
        observed = int(valid.sum())
        bnd_exact, by_exact = bound_ms(*kernel_work(L, P, T, 2, N, DIM, 1, observed))
        bnd, by = split_bound_ms(L, P, T, 2, N, DIM, 1, observed)
        plain = ({tier: time_ms(lambda tier=tier: msrouse_logL_sym_torch(
                     ops, s2, Cind, prof, ydata, valid, matmul=tier), 1)
                  for tier in SPLIT_TIERS} if L <= 640 else {})
        for tier in fns:
            t = float(np.mean(ms[tier]))
            b, by_t = (bnd_exact, by_exact) if tier == "exact" else (bnd, by)
            times[(tier, L)] = (t, plain.get(tier), b, by_t)
            pl = ("" if tier not in plain else
                  f"  plain {plain[tier]:9.3f} ms")
            print(f"time split phase {tier:9s} L={L:4d} P={P}: kernel {t:9.3f} ms "
                  f"({' / '.join(f'{x:.3f}' for x in ms[tier])}; "
                  f"{L * P / t * 1e3:12.1f} profiles/s){pl}  bound {b:.4f} ms "
                  f"({by_t}), {b / t:.1%} of bound", flush=True)
        del prof, ydata, valid

    # -- config 3 under 'exact' and 'auto', in one call ----------------------
    kw = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
              scout_steps=4, refine_top=3, marginals=True,
              optimize_boundaries=True, chunk_size=64)

    def run():
        return sample_dataset(model, trajs, **kw,
                              generator=torch.Generator().manual_seed(7))

    walls, result, launches = {"exact": [], "auto": []}, {}, {}
    for mode in ("exact", "auto", "exact", "auto", "auto", "exact"):
        bt.config.set_rouse_matmul(mode)
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        ran = counters.read()
        if mode not in result:
            result[mode], launches[mode] = res, ran
    summary = {}
    for mode in ("exact", "auto"):
        bt.config.set_rouse_matmul(mode)
        res, ran = result[mode], launches[mode]
        acc = float(np.mean(np.concatenate(res.best_profile()) == truths.ravel()))
        sw = float(np.mean(res.best_k() == true_k))
        share, _, _ = busy_share(run)
        wall = float(np.mean(walls[mode][1:]))
        summary[mode] = wall
        tier = bt.config.resolve_matmul("lockstep", T=T)
        print(f"split in-call config 3 rouse_matmul={mode!r} (lockstep tier "
              f"{tier!r}): wall {wall:.3f} s (the later calls; all: "
              f"{' / '.join(f'{w:.3f}' for w in walls[mode])} s), frame accuracy "
              f"{acc:.4f}, switch-count accuracy {sw:.4f}, device busy share "
              f"{share}, launches {ran}", flush=True)
        check(acc >= DATASET_FRAME_ACCURACY,
              f"config 3 {mode}: frame accuracy {acc:.4f} >= {DATASET_FRAME_ACCURACY}")
        check(sw >= DATASET_SWITCH_ACCURACY,
              f"config 3 {mode}: switch-count accuracy {sw:.4f} >= {DATASET_SWITCH_ACCURACY}")
        # the split tiers run on the sym kernel; 'exact' on the selected one
        kernel = ("kalman_sym" if tier != "exact"
                  else launched_kernel(bt.config.rouse_kernel(), "dataset"))
        check((ran["kalman_sym_split"] > 0) == (tier != "exact")
              and ran[kernel] > 0,
              f"config 3 {mode}: the {tier} tier ran ({kernel})")
        check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
              "no plain version ran on the CUDA path")
    bt.config.set_rouse_matmul(default)
    no_slower = summary["auto"] <= summary["exact"]
    may_auto = ladder_ok["split"] and no_slower
    print(f"split default gate: 'split' meets the T=100 ladder bars: "
          f"{ladder_ok['split']}; config 3 under 'auto' no slower than under "
          f"'exact': {no_slower} ({summary['auto']:.3f} s against "
          f"{summary['exact']:.3f} s); the default may be 'auto': {may_auto}; "
          f"the shipped default: {default!r}", flush=True)
    check(default != "auto" or may_auto,
          "the default is 'auto' only where its gate holds")
    print(f"split phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches["auto"]["kalman_sym_split"], "max_abs": max_abs,
            "times": times, "default": default}


# tools/parity_tiers.py's configuration (N=20, d=3, T=100, two states, a
# loop at frames 30-60 and 75-90, 64 every-frame random profiles), and
# bild_tpu's TPU v5e readings there against the float64 oracle
# (PARITY_TIERS_r04.json: sym exact, the XLA scan and sqrt, float32): max
# relative error, profiles per second
TIERS_T = 100
TIERS_PROFILES = 64
TIERS_TPU = {"kalman_sym float32": (2.63e-6, 554802),
             "plain float32": (4.60e-6, 123469),
             "sqrt float32": (4.88e-6, 20970)}
# bars: float64 on the card against the oracle (the kernels' float64
# builds are held to RTOL_F64 too); sqrt float32 against the oracle at
# T=100, bild_tpu's test_sqrt_f32_meets_north_star
RTOL_SQRT_F32 = 1e-6
# sqrt float32 against its float64 run at the ladder's T=1000 rung, in
# centered nats per profile family: bild_tpu's 0.11 (BASELINE.md:59-67),
# set before any run on the card from a CPU rehearsal of the port (float32
# against float64 at that rung) that read at most 0.010
SQRT_CENTERED_T1000 = 0.11


def tiers_phase(bt, ladder):
    """The parity tiers on the card: at `TIERS_T` (tools/parity_tiers.py's
    configuration) the sym and dense kernels, the plain recursion, the
    square-root filter and the temporal-parallel filter, in float32 and
    (the new filters) float64, each against the numpy float64 oracle and
    timed with CUDA events (profiles per second), beside bild_tpu's TPU
    readings. Then the square-root filter at the ladder's T=1000 rung
    (`ladder_case`: the same trajectory and profile families), float32
    against its float64 run, beside the kernels' drift from ``ladder``
    (`ladder_phase`'s result). Bars: float64 within `RTOL_F64` of the
    oracle (T=100) and of the dense kernel's float64 build (T=1000); sqrt
    float32 within `RTOL_SQRT_F32` of the oracle at T=100 and within
    `SQRT_CENTERED_T1000` centered nats per family at T=1000. Returns the
    kernels' launches in the evaluations (not the timing loops)."""
    from bild_tpu_torch.experimental.assoc_kalman import msrouse_logL_assoc_batch
    from bild_tpu_torch.ops.kalman import msrouse_logL_batch
    from bild_tpu_torch.ops.kalman_dense import msrouse_logL_dense
    from bild_tpu_torch.ops.kalman_sqrt import msrouse_logL_sqrt
    from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym
    from bild_tpu_torch.ops.oracle import msrouse_logL_numpy

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    models = {dtype: bt.models.MultiStateRouse(
        N, D, KSPRING, d=DIM, localization_error=0.1, device=DEVICE,
        dtype=dtype) for dtype in (f32, f64)}
    truth = np.zeros(TIERS_T, dtype=int)
    truth[30:60] = 1
    truth[75:90] = 1
    traj = models[f32].trajectory_from_loopingprofile(
        truth, generator=torch.Generator(device=DEVICE).manual_seed(42))
    prof = np.random.default_rng(2).integers(
        0, 2, size=(TIERS_PROFILES, TIERS_T)).astype(np.int32)
    h = models[f64].host
    noise = np.asarray(models[f64]._get_noise(traj))
    oracle = np.array([msrouse_logL_numpy(
        h["Bs"], h["Gs"], h["Sigs"], h["M0s"], h["C0s"], h["w"], noise, p,
        traj[:]) for p in prof])

    def args(models, traj, prof, dtype):
        m = models[dtype]
        s2, Cind = m._noise_arrays(traj)
        return (m.Bs, m.Gs, m.Sigs, m.M0s, m.C0s, m.w, s2, Cind,
                torch.as_tensor(prof, device=DEVICE), traj.data.to(dtype),
                traj.valid)

    a32, a64 = args(models, traj, prof, f32), args(models, traj, prof, f64)
    ops32 = models[f32].sym_operators()
    tiers = {                                  # label: (function, reps)
        "kalman_sym float32": (lambda: msrouse_logL_sym(*a32, ops=ops32), 20),
        "kalman_dense float32": (lambda: msrouse_logL_dense(*a32), 20),
        "plain float32": (lambda: msrouse_logL_batch(*a32), 3),
        "sqrt float32": (lambda: msrouse_logL_sqrt(*a32), 3),
        "sqrt float64": (lambda: msrouse_logL_sqrt(*a64), 3),
        "assoc float32": (lambda: msrouse_logL_assoc_batch(*a32), 3),
        "assoc float64": (lambda: msrouse_logL_assoc_batch(*a64), 3),
    }

    # the T=1000 rung
    models3, traj3, families, prof3, fam_of = ladder_case(bt, 1000, 3)
    b32, b64 = (args(models3, traj3, prof3, dt) for dt in (f32, f64))

    counters.reset()
    vals = {label: fn() for label, (fn, _) in tiers.items()}
    t0 = time.perf_counter()
    sq32 = msrouse_logL_sqrt(*b32)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    sq64 = msrouse_logL_sqrt(*b64)
    dense64 = msrouse_logL_dense(*b64)
    torch.cuda.synchronize()
    launches = counters.read()

    for label, (fn, reps) in tiers.items():
        got = vals[label].cpu().numpy().astype(float)
        check(got.shape == oracle.shape and np.all(np.isfinite(got)),
              f"tier {label}: finite, {oracle.shape}")
        err = rel_err(got, oracle)
        ms = time_ms(fn, reps)
        tpu = TIERS_TPU.get(label)
        tpu = ("" if tpu is None else f"; bild_tpu on a TPU v5e: {tpu[0]:.2e}, "
               f"{tpu[1]:.0f} profiles/s")
        print(f"tier {label:20s} N={N} T={TIERS_T} P={TIERS_PROFILES}: max rel "
              f"{err:.2e} against the float64 oracle, {ms:.3f} ms "
              f"({TIERS_PROFILES / ms * 1e3:.1f} profiles/s){tpu}", flush=True)
        if label.endswith("float64"):
            check(err <= RTOL_F64, f"tier {label}: within {RTOL_F64} of the oracle")
        if label == "sqrt float32":
            check(err <= RTOL_SQRT_F32,
                  f"tier {label}: within {RTOL_SQRT_F32} of the oracle")
    for shape in ((2 * N, N), (N + 1, N + 1)):
        qr = []
        for B in (1, TIERS_PROFILES, len(prof3)):
            A = torch.randn(B, *shape, device=DEVICE)
            qr.append(time_ms(lambda: torch.linalg.qr(A, mode="r"), 20))
        print(f"tier torch.linalg.qr float32 {shape}: batches 1 / "
              f"{TIERS_PROFILES} / {len(prof3)} take {qr[0]:.4f} / {qr[1]:.4f} "
              f"/ {qr[2]:.4f} ms", flush=True)

    sq32, sq64 = (x.cpu().numpy().astype(float) for x in (sq32, sq64))
    dense64 = dense64.cpu().numpy().astype(float)
    check(np.all(np.isfinite(sq32)) and np.all(np.isfinite(sq64)),
          "sqrt at T=1000: finite")
    e64 = rel_err(sq64, dense64)
    err = sq32 - sq64
    rel = float(np.max(np.abs(err / sq64)))
    cen_fams = [centered_nats(err[fam_of == i], fam_of[fam_of == i])
                for i in range(3)]
    kern = "; ".join(
        f"{name} {ladder[(name, 1000)][0]:.2e}, {ladder[(name, 1000)][1]:.4f} "
        f"nats, {' / '.join(f'{c:.4f}' for c in ladder[(name, 1000)][3])}"
        for name in ("kalman_sym", "kalman_dense"))
    line = (f"tier sqrt T=1000 n=3 ({len(prof3)} profiles, {wall32:.3f} s in "
            f"float32): float32 against its float64 run: max rel {rel:.2e}, max "
            f"{np.max(np.abs(err)):.4f} nats, mean {err.mean():.4f} nats, "
            f"centered {' / '.join(f'{c:.4f}' for c in cen_fams)} nats within "
            f"the {' / '.join(families)} family; float64 run against the dense "
            f"kernel's float64 build {e64:.2e}; the kernels' float32 against "
            f"their float64 build on the same profiles (ladder): {kern}; "
            f"bild_tpu's sym on a TPU v5e: {BILD_TPU_CENTERED_T1000} centered")
    print(line, flush=True)
    check(e64 <= RTOL_F64, f"{line}: float64 run within {RTOL_F64} of dense's")
    check(max(cen_fams) <= SQRT_CENTERED_T1000,
          f"{line}: float32 within {SQRT_CENTERED_T1000} centered nats per family")
    print(f"tiers phase: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{launches}", flush=True)
    return launches


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
        label = (f"kalman_dense range N={n_mono} q={s2.shape[0]} {str(dtype)[6:]}, "
                 f"{8 * plan.cov_itemsize}-bit covariance")
        check(not plan.ops_shared, f"{label}: operators in global memory")
        check(plan.cov_itemsize == (4 if dtype == torch.float32 else 8),
              f"{label}: float32 keeps its covariance in float32 only here")
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                s2, Cind, torch.as_tensor(prof, device=DEVICE), traj.data, traj.valid)
        counters.reset(["kalman_dense_cov32"])
        got = msrouse_logL_dense(*args)
        check(counters.read(["kalman_dense_cov32"])["kalman_dense_cov32"]
              == (plan.cov_itemsize == 4), f"{label}: counted as such")
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
    truths, true_k, batch, trajs = config3_data(model, B, T)
    kw = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
              scout_steps=4, refine_top=3, marginals=True,
              optimize_boundaries=True, chunk_size=chunk_size)
    n_chunks = -(-B // chunk_size)
    out = {}
    found = bt.config.rouse_kernel()
    for selector in ("auto", "sym", "dense"):
        bt.config.set_rouse_kernel(selector)
        with tempfile.TemporaryDirectory() as ck:
            def run():
                return sample_dataset(model, trajs, **kw, checkpoint_dir=ck,
                                      generator=torch.Generator().manual_seed(7))

            counters.reset()
            run_lanes.steps = run_lanes.lane_steps = 0
            optimize_boundary_batch.evaluations = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = counters.read()
            evals = run_lanes.lane_steps * kw["N"] + optimize_boundary_batch.evaluations
            steps, lane_steps = run_lanes.steps, run_lanes.lane_steps
            check(len(os.listdir(ck)) == n_chunks, f"{n_chunks} chunk files written")
            counters.reset()
            again = run()
            reloaded = counters.read()
        acc = float(np.mean(np.concatenate(res.best_profile()) == truths.ravel()))
        sw = float(np.mean(res.best_k() == true_k))
        acc_opt = float(np.mean(np.concatenate(res.optimized) == truths.ravel()))
        print(f"dataset selector={selector} (matmul tier "
              f"{bt.config.resolve_matmul('lockstep', T=T)!r}): wall {wall:.3f} s, "
              f"{B / wall:.2f} trajectories/s, {evals / wall:.1f} profile "
              f"evaluations/s ({evals} evaluations), lockstep AMIS steps "
              f"{steps} ({lane_steps} lane-steps), frame accuracy {acc:.4f}, "
              f"switch-count accuracy {sw:.4f}, after the boundary climb "
              f"{acc_opt:.4f} ({int(res.eliminated.sum())} eliminated), "
              f"launches {ran}", flush=True)
        kernel = launched_kernel(selector, "dataset")
        check(ran[kernel] > 0, f"{selector}: {kernel} launched")
        check(selector != "auto" or ran["kalman_sym"] == ran["kalman_sym_cluster"],
              "auto: no launch of the packed kernel's tile plan")
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
        share, top, _ = busy_share(lambda: sample_dataset(
            model, trajs, **kw, generator=torch.Generator().manual_seed(7)))
        print(f"dataset selector={selector}: device busy share {share}",
              flush=True)
        for name, (ms, cnt) in top:
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
    bt.config.set_rouse_kernel(found)
    return out


def busy_share(run):
    """``(device busy share text, top device events)`` of one traced call
    of ``run``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = device_time_by_name(prof)
    busy = sum(ms for ms, _ in by_name.values())
    text = (f"{busy / 1e3 / wall:.4f} ({busy:.1f} ms of {wall:.3f} s profiled "
            f"wall, {sum(c for _, c in by_name.values())} device events)"
            if busy > 0 else "not measured (no device events in the trace)")
    return text, sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5], out


def adaptive_phase(bt, B=128):
    """Config 3 through `sample_dataset(schedule='adaptive', chunk_size=128)`
    (bild_tpu's recorded adaptive settings, ADAPTIVE_34_r05.json), once per
    kernel selector: wall, rounds, evaluations, accuracy against the bars
    and below the lockstep schedule's 5,632 evaluations per trajectory,
    the launch counters, a rerun that loads the chunk, the same bits from
    the same seed (the traced run), and `sample_batch_adaptive` on the same
    chunk for ``evals == N * steps``."""
    from bild_tpu_torch.amis.sampler import draw_seed
    from bild_tpu_torch.infer.adaptive import sample_batch_adaptive
    from bild_tpu_torch.lanes import mix_int
    from bild_tpu_torch.parallel import sample_dataset

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    truths, true_k, batch, trajs = config3_data(model, B, T)
    kw = dict(k_max=4, N=128, informed_init=True, init_steps=4,
              steps_per_round=2, max_steps_per_k=24, samplesize=4096)
    out = {}
    found = bt.config.rouse_kernel()
    for selector in ("auto", "sym", "dense"):
        bt.config.set_rouse_kernel(selector)
        with tempfile.TemporaryDirectory() as ck:
            def run(ck=ck):
                return sample_dataset(model, trajs, **kw, schedule="adaptive",
                                      chunk_size=B, checkpoint_dir=ck,
                                      generator=torch.Generator().manual_seed(7))

            counters.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = counters.read()
            check(len(os.listdir(ck)) == 1, "one chunk file written")
            counters.reset()
            again = run()
            reloaded = counters.read()
        acc = float(np.mean(np.concatenate(res.best_profile()) == truths.ravel()))
        sw = float(np.mean(res.best_k() == true_k))
        ev = res.evals
        q = np.quantile(ev, [0.1, 0.5, 0.9])
        share, top, traced = busy_share(lambda: run(ck=None))
        # the chunk's own generator, as sample_dataset seeds chunk 0
        seed = draw_seed(torch.Generator().manual_seed(7))
        direct = sample_batch_adaptive(
            model, batch, **kw, generator=torch.Generator(device=DEVICE)
            .manual_seed(mix_int(seed) & (2**63 - 1)))
        print(f"adaptive selector={selector} (matmul tier "
              f"{bt.config.resolve_matmul('lockstep', T=T)!r}): wall {wall:.3f} s, "
              f"{B / wall:.2f} trajectories/s, likelihood evaluations per "
              f"trajectory mean {ev.mean():.1f} (q10/50/90 {q[0]:.0f}/"
              f"{q[1]:.0f}/{q[2]:.0f}; lockstep 5632), frame accuracy "
              f"{acc:.4f}, switch-count accuracy {sw:.4f}, launches {ran}; "
              f"sample_batch_adaptive alone: {direct.rounds} rounds, "
              f"{int(direct.steps.sum())} lane-steps; device busy share {share}",
              flush=True)
        for name, (ms, cnt) in top:
            print(f"    {ms:10.1f} ms {cnt:7d}x  {name[:90]}", flush=True)
        kernel = launched_kernel(selector, "dataset")
        check(ran[kernel] > 0, f"{selector}: {kernel} launched")
        check(selector != "auto" or ran["kalman_sym"] == ran["kalman_sym_cluster"],
              "auto: no launch of the packed kernel's tile plan")
        check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
              "no plain version ran on the CUDA path")
        check(acc >= DATASET_FRAME_ACCURACY,
              f"frame accuracy {acc:.4f} >= {DATASET_FRAME_ACCURACY}")
        check(sw >= DATASET_SWITCH_ACCURACY,
              f"switch-count accuracy {sw:.4f} >= {DATASET_SWITCH_ACCURACY}")
        check(ev.mean() < LOCKSTEP_EVALS,
              f"mean evaluations {ev.mean():.1f} < lockstep {LOCKSTEP_EVALS}")
        check(np.all(np.isfinite(res.evidence[:, 0])), "k=0 evidence finite")
        check(res.mom_ok.all(), "CFC fixed point converged in every lane")
        check(all(v == 0 for v in reloaded.values()),
              f"rerun loaded the chunk, launched nothing: {reloaded}")
        for other, what in ((again, "rerun from the chunk checkpoint"),
                            (traced, "a second run from the same seed")):
            check(np.array_equal(other.evidence, res.evidence)
                  and np.array_equal(other.evals, res.evals)
                  and all(np.array_equal(a, b) for a, b in zip(
                      other.profiles_by_k, res.profiles_by_k)),
                  f"{what} returns identical arrays")
        check(np.array_equal(direct.evals, kw["N"] * direct.steps.sum(axis=1)),
              "evals == N x the lane steps")
        check(np.array_equal(direct.evidence, res.evidence),
              "sample_batch_adaptive on the chunk equals the dataset run")
        out[selector] = ran
    bt.config.set_rouse_kernel(found)
    return out


# config 4's bars: bild_tpu recorded frame / switch-count accuracy 0.987 /
# 0.8125, 0.9923 / 0.6875 and 0.9919 / 0.8125 (PERF_r02-r04.json), and a
# switch-count spread of 0.5625-0.8125 over four keys at B=16
# (CONFIG4_FORENSICS_r04.json)
CONFIG4_FRAME_ACCURACY = 0.97
CONFIG4_SWITCH_ACCURACY = 0.50
CONFIG4_KW = dict(k_max=6, steps_per_k=12, N=128, informed_init=True,
                  scout_steps=4, refine_top=3)


def config4_phase(bt, drift):
    """bench_e2e.py config 4 at full size (three states, 16 trajectories of
    T=1000, `sample_batch(k_max=6, steps_per_k=12, N=128, informed_init,
    scout_steps=4, refine_top=3)`), once per kernel selector: accuracy
    against the bars, the launch counters (the selected kernel, no plain
    version), the wall, the peak device memory, and the device-busy share
    of a second, traced run from the same seed (the same bits). The
    smallest evidence gap between the best and the next k is printed
    beside the selected kernel's float32 drift at config 4's launches
    (``drift``: `lockstep_phase`'s centered nats against its float64
    build)."""
    from bild_tpu_torch.parallel import sample_batch
    from bild_tpu_torch.parallel.batch import run_lanes

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      looppositions=THREE_STATES,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    truths, true_k, batch = config4_data(model)
    out = {}
    found = bt.config.rouse_kernel()
    for selector in ("auto", "sym", "dense"):
        bt.config.set_rouse_kernel(selector)

        def run():
            return sample_batch(model, batch, **CONFIG4_KW,
                                generator=torch.Generator().manual_seed(4))

        counters.reset()
        run_lanes.steps = run_lanes.lane_steps = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = counters.read()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, lane_steps = run_lanes.steps, run_lanes.lane_steps
        share, top, traced = busy_share(run)
        acc = float(np.mean(res.best_profile() == truths))
        sw = float(np.mean(res.best_k() == true_k))
        # the close calls against the kernel's float32 drift at T=1000
        rows = np.arange(len(truths))
        ev = np.sort(np.where(np.isfinite(res.evidence), res.evidence, -np.inf), axis=1)
        gaps = ev[:, -1] - ev[:, -2]
        se = res.evidence_se[rows, res.best_k()]
        own = max(v for (k, label), v in drift.items()
                  if k == launched_kernel(selector, "config 4")
                  and label.startswith("config 4"))
        print(f"config 4 selector={selector}: evidence gap between the best "
              f"and the next k: median {np.median(gaps):.3f}, min "
              f"{np.min(gaps):.3f} nats; evidence standard error at the best k: "
              f"median {np.median(se):.3f}, min {np.min(se):.3f} nats; the "
              f"float32 kernel's drift from its float64 build at config 4's "
              f"launches: {own:.4f} centered nats (below the smallest gap: "
              f"{own < np.min(gaps)})", flush=True)
        print(f"config 4 selector={selector}: B={len(truths)} T={truths.shape[1]} "
              f"n=3 (matmul tier "
              f"{bt.config.resolve_matmul('lockstep', T=truths.shape[1])!r}): "
              f"wall {wall:.3f} s, "
              f"{len(truths) / wall:.2f} trajectories/s, lockstep AMIS steps "
              f"{steps} ({lane_steps} lane-steps), frame accuracy {acc:.4f}, "
              f"switch-count accuracy {sw:.4f}, best k {res.best_k().tolist()} "
              f"(true {true_k.tolist()}), peak device memory {peak:.2f} GiB, "
              f"launches {ran}; device busy share {share}", flush=True)
        for name, (ms, cnt) in top:
            print(f"    {ms:10.1f} ms {cnt:7d}x  {name[:90]}", flush=True)
        kernel = launched_kernel(selector, "config 4")
        check(ran[kernel] > 0, f"{selector}: {kernel} launched")
        check(selector != "auto" or ran["kalman_sym"] == ran["kalman_sym_cluster"],
              "auto: no launch of the packed kernel's tile plan")
        check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
              "no plain version ran on the CUDA path")
        check(acc >= CONFIG4_FRAME_ACCURACY,
              f"config 4 frame accuracy {acc:.4f} >= {CONFIG4_FRAME_ACCURACY}")
        check(sw >= CONFIG4_SWITCH_ACCURACY,
              f"config 4 switch-count accuracy {sw:.4f} >= {CONFIG4_SWITCH_ACCURACY}")
        check(np.all(np.isfinite(res.evidence)) and res.mom_ok.all(),
              "every evidence finite, CFC converged in every lane")
        check(np.array_equal(traced.evidence, res.evidence)
              and np.array_equal(traced.map_profiles, res.map_profiles),
              "the traced run from the same seed gives the same bits")
        out[selector] = ran
    bt.config.set_rouse_kernel(found)
    return out


# ---------------------------------------------------------------------------
# the CFC fixed-point kernel, and the dataset runners' step as a CUDA graph
# ---------------------------------------------------------------------------

# csrc/cfc_solve.cu against the plain solve on the same inputs: float64
# relative error, float32 in units in the last place of the plain value
RTOL_CFC_F64 = 1e-12
ULP_CFC_F32 = 4


def cfc_ops(n):
    """Operations of one iteration of one slot's solve with ``n`` states
    (an addition, subtraction, comparison, exp or log counts one): 2n + 1
    log-sum-exps of n entries (n - 1 comparisons, n subtractions, n exps,
    p2 - 1 additions for p2 the power of two >= n, a log and an addition),
    the n^2 differences g - norm, and 5n for the weights, their
    normalization, the change, its maximum and the test."""
    p2 = 1 << (n - 1).bit_length()
    lse = (n - 1) + 2 * n + (p2 - 1) + 2
    return (2 * n + 1) * lse + n * n + 5 * n


def cfc_bound_ms(M, n, itemsize, iterations):
    """The least time of one solve of ``M`` slots on the card: the
    operations of the ``iterations`` these inputs take (`cfc_ops` each) at
    the float32 peak, or the bytes (logf, logg and logp (M, n), the
    transition matrix, the frozen and converged flags, each once) at the
    HBM rate."""
    return bound_ms(iterations * cfc_ops(n),
                    3 * M * n * itemsize + n * n + 2 * M)


def ulp_err(got, want):
    """Largest |got - want| in units in the last place of ``want`` (in its
    type) over its finite entries."""
    fin = torch.isfinite(want)
    w = want[fin]
    ulp = torch.nextafter(w.abs(), torch.full_like(w, math.inf)) - w.abs()
    return float(((got[fin] - w).abs() / ulp).max()) if w.numel() else 0.0


GAMMA_ULP = 4
# 32-bit integer instructions of one SplitMix64 finalizer (`mix64`) on the
# card: two 64-bit products (three 32-bit multiply-adds each), three
# 64-bit shifts and three 64-bit xors (two 32-bit instructions each)
MIX64_INT_OPS = 18
# The H100's 32-bit integer rate: 64 integer lanes per SM beside 128
# float32 lanes (NVIDIA's Hopper white paper), and bench_torch.py's float32
# peak counts an FMA as two operations: a quarter of that peak
PEAK_INT_OPS = bench_torch.PEAK_FLOPS_F32 / 4
# the float32 gamma case a degenerate proposal gives (`step_kernel_phase`):
# shapes 10^U(5, 10) at config 3's scout shape, where the Marsaglia-Tsang
# test cancels and an entry needs up to tens of rounds
DEGENERATE_SHAPES = (5.0, 10.0)
# device time (`device_ms`): launches captured in one CUDA graph, and its
# replays timed
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 10


def gamma_ops(rounds):
    """Floating-point operations of ``rounds`` rounds of the gamma kernel:
    three uniforms (an addition and a product each), the normal (two
    products, a log, a sqrt, a cos, a product), v (a product, an addition,
    two products), log v, the test (a log and seven operations) and the
    accepted value."""
    return 26 * rounds


def gamma_int_ops(entries, rounds, lane_rounds):
    """32-bit integer instructions of the streams' hashing that ``rounds``
    entry-rounds over ``entries`` entries and ``lane_rounds`` lane-rounds
    need: per entry-round three element hashes (a `mix64` and a 64-bit
    addition each), per entry its element offset (a 64-bit product), per
    lane and round its three stream words (four folds of two `mix64`, a
    64-bit addition and a xor each)."""
    return (rounds * 3 * (MIX64_INT_OPS + 2) + entries * 3
            + lane_rounds * 4 * (2 * MIX64_INT_OPS + 4))


def gamma_bound_ms(d, keys, rounds, lane_rounds):
    """``(ms, what bounds it, (float ms, integer ms, bytes ms))``: the least
    time of these inputs' rounds on the card, the larger of their float
    operations (`gamma_ops`) at the float32 peak, their integer hashing
    (`gamma_int_ops`) at `PEAK_INT_OPS`, and the bytes (d, c, the result,
    the keys, each once) at the HBM rate."""
    t_float = gamma_ops(rounds) / bench_torch.PEAK_FLOPS_F32 * 1e3
    t_int = (gamma_int_ops(d.numel(), rounds, lane_rounds) / PEAK_INT_OPS
             * 1e3)
    t_bytes = ((3 * d.numel() * d.element_size() + 8 * keys.numel())
               / bench_torch.PEAK_BYTES * 1e3)
    ms = max(t_float, t_int, t_bytes)
    return ms, ("bytes" if ms == t_bytes else "operations"), (t_float, t_int,
                                                             t_bytes)


def cfc_iterations(solve, logf, logg, tr, maxiter, precision, frozen):
    """``(iterations summed over slots, most of one slot)`` that the CFC
    solve of these inputs runs: a slot runs one iteration for every cut
    ``m < maxiter`` of its loop at which it has not converged, so the sum
    reads the converged flags of ``solve`` at maxiter = 0, 1, ... (the
    flags no longer change once they equal the full solve's)."""
    _, final = solve(logf, logg, tr, maxiter, precision, frozen=frozen)
    left = int((~final).sum())
    total = 0
    for m in range(maxiter):
        _, conv = solve(logf, logg, tr, m, precision, frozen=frozen)
        if torch.equal(conv, final):
            return total + left * (maxiter - m), maxiter if left else m
        total += int((~conv).sum())
    return total, maxiter


def gamma_rounds(d, c, keys):
    """``(entry-rounds, most rounds of one entry, lane-rounds)`` that the
    gamma sampler draws on these inputs: every entry draws round 1, and one
    more for every cut m >= 1 of the plain loop (``max_rounds=m``) at which
    it is still unaccepted (its draw still 0); a lane draws as many rounds
    as its last entry."""
    from bild_tpu_torch.amis import dirichlet
    from bild_tpu_torch.lanes import LaneRNG

    total, lanes, m = d.numel(), keys.numel(), 1
    while True:
        flag = torch.zeros((), dtype=torch.bool, device=d.device)
        out = dirichlet._gamma_accept(d, c, LaneRNG(keys, flag), max_rounds=m)
        if not bool(flag):
            return total, m, lanes
        left = (out == 0).reshape(keys.numel(), -1)
        total += int(left.sum())
        lanes += int(left.any(dim=1).sum())
        m += 1


def card():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def device_ms(fn):
    """Device milliseconds of one call of ``fn``: `GRAPH_LAUNCHES` calls
    captured in one CUDA graph (no host work left between its kernels),
    the graph replayed `GRAPH_REPLAYS` times between two CUDA events after
    one warm replay, over the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (GRAPH_REPLAYS * GRAPH_LAUNCHES)
    del graph
    return ms


# The parent commit's kernels, timed beside this checkout's when a
# checkout of the parent lies at `PARENT_TREE` (a `git archive` unpacked
# under the git-ignored _chip/) or at ``--parent DIR``: its
# csrc/cfc_solve.cu and csrc/gamma_accept.cu (launched with this
# checkout's `solve_plan` and `gamma_plan`), and its two likelihood kernels
# (csrc/kalman_sym.cu, csrc/kalman_dense.cu), with their C entry points,
# (pointers, ints, doubles).
PARENT_TREE = Path(__file__).resolve().parent / "_chip" / "parent"
PARENT_ENTRIES = {"cfc_solve": ("bild_cfc_solve", 6, 6, 1),
                  "gamma_accept": ("bild_gamma_accept", 5, 7, 0),
                  "kalman_sym": ("bild_kalman_sym", 13, 12, 0),
                  "kalman_dense": ("bild_kalman_dense", 12, 11, 0)}


def build_parent(tree, name):
    """``tree``'s bild_tpu_torch/csrc/<name>.cu built with this checkout's
    nvcc flags into _build/parent-<name>.so, loaded."""
    import ctypes

    from bild_tpu_torch.ops import _build

    src = Path(tree) / "bild_tpu_torch" / "csrc" / f"{name}.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"parent-{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(src.parent), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"the parent's {name} builds: {proc.stderr}")
    return ctypes.CDLL(str(out))


def parent_entry(lib, name, dtype):
    """The parent's C entry point of ``name`` for ``dtype``, typed."""
    import ctypes

    symbol, n_ptr, n_int, n_double = PARENT_ENTRIES[name]
    fn = getattr(lib, f"{symbol}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_double] * n_double + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def parent_gamma(lib, d, c, keys):
    """A call of the parent's gamma kernel on ``(d, c, keys)``: ``run() ->
    (out, exhausted flag)``."""
    from bild_tpu_torch.amis import dirichlet

    fn = parent_entry(lib, "gamma_accept", d.dtype)
    L = keys.numel()
    d, c, keys = d.contiguous(), c.contiguous(), keys.contiguous()

    def run():
        out = torch.empty_like(d)
        flag = torch.zeros((), dtype=torch.bool, device=d.device)
        per_lane = d.numel() // L
        rc = fn(d.data_ptr(), c.data_ptr(), keys.data_ptr(), out.data_ptr(),
                flag.data_ptr(), L, per_lane, *dirichlet.gamma_plan(L, per_lane),
                dirichlet.GAMMA_MAX_ROUNDS, d.device.index or 0,
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the parent's gamma kernel launches (error {rc})")
        return out, flag
    return run


def parent_cfc(lib, logf, logg, tr, maxiter, precision, frozen):
    """A call of the parent's CFC kernel: ``run() -> (logp, converged)``."""
    from bild_tpu_torch.amis.cfc import solve_plan

    fn = parent_entry(lib, "cfc_solve", logf.dtype)
    lead = logf.shape[:-1]
    # the kernel reads rows of n contiguous entries, as the wrapper hands it
    logf, logg = logf.contiguous(), logg.contiguous()
    frozen = None if frozen is None else frozen.contiguous()
    tr = tr.to(torch.bool).contiguous()

    def run():
        logp = torch.empty_like(logf)
        conv = torch.empty(lead, dtype=torch.bool, device=logf.device)
        M, n = math.prod(lead), logf.shape[-1]
        group, threads, _ = solve_plan(M, n)
        rc = fn(logf.data_ptr(), logg.data_ptr(), tr.data_ptr(),
                None if frozen is None else frozen.data_ptr(), logp.data_ptr(),
                conv.data_ptr(), M, n, int(maxiter), group, threads,
                logf.device.index or 0, float(precision),
                torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the parent's CFC kernel launches (error {rc})")
        return logp, conv
    return run


def ptxas_rows(report):
    """`ptxas_report`'s tuples as dicts, for the JSON line."""
    return {k: dict(zip(("registers", "stack_frame", "spill_stores", "spill_loads"), v))
            for k, v in report.items()}


def ptxas_report(name):
    """``nvcc -Xptxas -v`` of csrc/<name>.cu with the build's flags:
    ``{kernel (demangled where it is a template of this repository):
    (registers, stack frame bytes, spill store bytes, spill load
    bytes)}``."""
    import re

    from bild_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",)]
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *flags, "-c", "-Xptxas", "-v",
                               "-I", str(_build.CSRC), "-o",
                               os.path.join(tmp, f"{name}.o"),
                               str(_build.CSRC / f"{name}.cu")],
                              capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc -Xptxas -v {name}: {proc.stderr}")
    out, kernel, frame = {}, None, None
    for ln in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            raw, kernel = m.group(1), m.group(1)
            for known in ("cfc_solve_kernel_wide", "cfc_solve_kernel",
                          "gamma_accept_kernel"):
                t = re.search(known + r"I([fd])(?:Li(\d+)E)?E", raw)
                if t:
                    kernel = (f"{known}<{'float' if t.group(1) == 'f' else 'double'}"
                              + (f", {t.group(2)}>" if t.group(2) else ">"))
                    break
            # the likelihood kernels: <operators, covariance[, operators shared]>
            t = re.search(r"(kalman_sym_cluster_kernel|kalman_sym_kernel|"
                          r"kalman_dense_kernel)I([fd])([fd])"
                          r"(?:Lb([01])E)?E", raw)
            if t:
                types = {"f": "float", "d": "double"}
                kernel = (f"{t.group(1)}<{types[t.group(2)]}, {types[t.group(3)]}"
                          + ("" if t.group(4) is None
                             else f", {'true' if t.group(4) == '1' else 'false'}")
                          + ">")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            frame = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel is not None:
            out[kernel] = (int(m.group(1)), *(frame or (0, 0, 0)))
            kernel, frame = None, None
    return out


def step_kernel_phase(bt, parent=None, ptxas=None):
    """The step's two kernels against their plain versions on every input
    the main path gives them, recorded by wrapping `cfc.solve_marginals`
    and `dirichlet.gamma_accept` during eager runs: config 3's lockstep
    `sample_batch(k_max=4, steps_per_k=12, N=128, informed_init,
    scout_steps=4, refine_top=3)` over 128 trajectories (scout L=640,
    refine L=384), and every run of the graph phase under 'sym'
    (`graph_cases`: config 3's lockstep and adaptive `sample_dataset`,
    config 4 with three states, the README `sample()` (one lane, 100 x 21
    gamma entries, 20 slots), the `ggm_model` example's `sample()`, GGM
    configs 6 and 7).
    csrc/cfc_solve.cu against `_solve_marginals` with lane-exact sums:
    float32 within `ULP_CFC_F32` ulp, the inputs in float64 within
    `RTOL_CFC_F64`, converged flags and non-finite entries equal.
    csrc/gamma_accept.cu against `_gamma_accept`: within `GAMMA_ULP` ulp
    in float32 and float64, no exhaustion; also a float32 case of
    degenerate shapes (`DEGENERATE_SHAPES`) at config 3's scout shape.
    Timed, by device time (`device_ms`), host time of back-to-back
    wrapper calls beside it (the kernel's and the plain version's at
    config 3's scout only): the CFC solve at config 3's scout call that
    iterates most, `sample()`'s and config 4's (three states) call whose
    longest row iterates most, beside `cfc_bound_ms` and the longest row's
    device time per iteration; the gamma kernel at config 3's scout call
    that draws most, `sample()`'s, and the degenerate case, beside
    `gamma_bound_ms` and `torch._standard_gamma` at the same shapes (the
    library's gamma draws, another stream: time only). With ``parent``
    (``{name: ctypes library}`` of `build_parent`) the parent's kernels on
    the same inputs, timed in turns with this checkout's (parent, change,
    change, parent) and held to the same bits. ``ptxas``: `ptxas_report`
    of both sources; every group instantiation of the CFC kernel must use
    no stack frame and spill nothing. Returns ``{name: numbers of the
    kernels line}``."""
    from bild_tpu_torch.amis import cfc, dirichlet
    from bild_tpu_torch.lanes import LaneRNG
    from bild_tpu_torch.parallel import graphs, sample_batch

    parent = parent or {}
    for name, report in (ptxas or {}).items():
        for kernel, (regs, stack, spill_st, spill_ld) in sorted(report.items()):
            print(f"ptxas {name} {kernel}: {regs} registers, {stack} bytes "
                  f"stack frame, {spill_st} / {spill_ld} bytes spill stores / "
                  f"loads", flush=True)
    groups = {k: v for k, v in (ptxas or {}).get("cfc_solve", {}).items()
              if k.startswith("cfc_solve_kernel<")}
    if ptxas:
        check(len(groups) == 16 and all(v[1:] == (0, 0, 0)
                                        for v in groups.values()),
              "cfc_solve: every group instantiation (n = 1..8, both types) "
              "has no stack frame and no spills")

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    _, _, batch, _ = config3_data(model, 128, T)
    runs = [("config 3 lockstep sample_batch",
             lambda: sample_batch(model, batch, k_max=4, steps_per_k=12, N=128,
                                  informed_init=True, scout_steps=4,
                                  refine_top=3,
                                  generator=torch.Generator().manual_seed(7)))]
    runs += [(label, run) for label, sel, run, *_ in graph_cases(bt)
             if sel == "sym"]
    solves, gammas = {}, {}
    solve, accept = cfc.solve_marginals, dirichlet.gamma_accept

    def record_solve(logf, logg, transitions, maxiter, precision, frozen=None,
                     exact=False):
        solves[label].append((logf.clone(), logg.clone(), transitions, maxiter,
                              precision, None if frozen is None
                              else frozen.expand(logf.shape[:-1]).clone()))
        return solve(logf, logg, transitions, maxiter, precision,
                     frozen=frozen, exact=exact)

    def record_gamma(d, c, generator):
        gammas[label].append((d.clone(), c.clone(), generator.keys.clone()))
        return accept(d, c, generator)

    # each wrapper counts its launches on the module's name: the recorder's
    # meanwhile
    record_solve.launches = record_gamma.launches = 0
    cfc.solve_marginals, dirichlet.gamma_accept = record_solve, record_gamma
    graphs._EAGER = True                  # every step's calls are recorded
    found = bt.config.rouse_kernel()
    bt.config.set_rouse_kernel("sym")
    try:
        for label, run in runs:
            solves[label], gammas[label] = [], []
            run()
    finally:
        cfc.solve_marginals, dirichlet.gamma_accept = solve, accept
        solve.launches += record_solve.launches
        accept.launches += record_gamma.launches
        graphs._EAGER = False
        bt.config.set_rouse_kernel(found)

    def shapes(recs):
        return sorted({tuple(r[0].shape) for r in recs})

    # the CFC solve
    ulps, rels, max_abs, unconverged = [], [], 0.0, 0
    for recs in solves.values():
        for logf, logg, tr, maxiter, precision, frozen in recs:
            for dtype in (torch.float32, torch.float64):
                f, g = logf.to(dtype), logg.to(dtype)
                got, conv = cfc.solve_marginals(f, g, tr, maxiter, precision,
                                                frozen=frozen)
                want, wconv = cfc._solve_marginals(f, g, tr, maxiter, precision,
                                                   frozen=frozen, exact=True)
                check(torch.equal(conv, wconv), "cfc_solve: converged flags equal")
                check(torch.equal(got.isfinite(), want.isfinite())
                      and torch.equal(got[~want.isfinite()].nan_to_num(),
                                      want[~want.isfinite()].nan_to_num()),
                      "cfc_solve: non-finite entries where the plain solve has them")
                fin = want.isfinite()
                if dtype == torch.float32:
                    ulps.append(ulp_err(got, want))
                    max_abs = max(max_abs,
                                  float((got[fin] - want[fin]).abs().max()))
                    unconverged += int((~conv).sum())
                else:
                    rels.append(float(((got[fin] - want[fin]).abs()
                                       / want[fin].abs().clamp_min(1e-300)).max()))
    line = (f"cfc_solve: {sum(map(len, solves.values()))} solves of the main "
            f"path's runs ("
            + "; ".join(f"{k}: {len(v)}, shapes {shapes(v)}"
                        for k, v in solves.items())
            + f"), kernel against plain: float32 max {max(ulps):.1f} ulp (bar "
            f"{ULP_CFC_F32}), max abs {max_abs:.3e}; float64 max rel "
            f"{max(rels):.2e} (bar {RTOL_CFC_F64}); {unconverged} unconverged slots")
    print(line, flush=True)
    check(max(ulps) <= ULP_CFC_F32 and max(rels) <= RTOL_CFC_F64, line)
    check(any(r[0].shape[-1] == 3 for r in solves["config 4"]),
          "cfc_solve: config 4's three-state solves were held to the plain solve")

    # the gamma sampler's rounds, and the degenerate float32 case
    scout = gammas["config 3 lockstep sample_batch"]
    d0, _, keys0 = scout[0]
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    lo, hi = DEGENERATE_SHAPES
    alpha = 10.0 ** (lo + (hi - lo) * torch.rand(d0.shape, generator=gen,
                                                 device=DEVICE))
    degenerate = (alpha - 1.0 / 3.0, 1.0 / torch.sqrt(9.0 * (alpha - 1.0 / 3.0)),
                  keys0)
    g_ulps, g_abs, differ, held = [], 0.0, 0, 0
    for label, recs in (*gammas.items(), ("degenerate float32", [degenerate])):
        for d, c, keys in recs:
            for dtype in ((torch.float32,) if label == "degenerate float32"
                          else (torch.float32, torch.float64)):
                dd, cc = d.to(dtype), c.to(dtype)
                flag = torch.zeros((), dtype=torch.bool, device=DEVICE)
                got = dirichlet.gamma_accept(dd, cc, LaneRNG(keys, flag))
                want = dirichlet._gamma_accept(dd, cc, LaneRNG(keys))
                check(not bool(flag), "gamma_accept: every entry accepted")
                g_ulps.append(ulp_err(got, want))
                differ += int((got != want).sum())
                held += got.numel()
                if dtype == torch.float32:
                    g_abs = max(g_abs, float((got - want).abs().max()))
    line = (f"gamma_accept: {sum(map(len, gammas.values()))} calls of the main "
            f"path's runs ("
            + "; ".join(f"{k}: {len(v)}, shapes {shapes(v)}"
                        for k, v in gammas.items())
            + f") and the degenerate float32 case {tuple(d0.shape)}, kernel "
            f"against plain: max {max(g_ulps):.1f} ulp (bar {GAMMA_ULP}), max "
            f"abs {g_abs:.3e} (float32), {differ} of {held} entries not "
            "bit-equal (both types)")
    print(line, flush=True)
    check(max(g_ulps) <= GAMMA_ULP, line)

    def in_turns(new, old):
        """Device ms of ``new`` and ``old`` (None: not timed), timed old,
        new, new, old: ``(new ms, old ms or None)``."""
        if old is None:
            return (device_ms(new) + device_ms(new)) / 2, None
        o1, n1, n2, o2 = (device_ms(fn) for fn in (old, new, new, old))
        return (n1 + n2) / 2, (o1 + o2) / 2

    def nums(x, digits=4):
        return "not measured" if x is None else f"{x * 1e3:.{digits}f} us"

    name_limit = card()
    out = {"cfc_solve": {}, "gamma_accept": {}}

    # the CFC solve: config 3's scout call that iterates most, sample()'s
    # and config 4's call whose longest row iterates most
    c3 = solves["config 3 lockstep sample_batch"]
    its = {}

    def iterations(rec):
        key = id(rec)
        if key not in its:
            its[key] = cfc_iterations(solve, *rec[:5], rec[5])
        return its[key]

    cases = {
        "config3": max((r for r in c3 if r[0].shape == c3[0][0].shape),
                       key=lambda r: iterations(r)[0]),
        "sample": max(solves["README sample()"], key=iterations),
        "config4": max((r for r in solves["config 4"] if r[0].shape[-1] == 3),
                       key=lambda r: iterations(r)[1]),
    }
    for key, rec in cases.items():
        logf, logg, tr, maxiter, precision, frozen = rec
        # the main path hands the wrapper transposed views, which it copies:
        # timed on rows of n contiguous entries, a launch is the kernel's
        logf, logg = logf.contiguous(), logg.contiguous()
        M, n = math.prod(logf.shape[:-1]), logf.shape[-1]
        total, most = iterations(rec)

        def kern():
            return cfc.solve_marginals(logf, logg, tr, maxiter, precision,
                                       frozen=frozen)
        old = None
        if "cfc_solve" in parent:
            old = parent_cfc(parent["cfc_solve"], logf, logg, tr, maxiter,
                             precision, frozen)
            got, want = old(), kern()
            check(torch.equal(got[1], want[1])
                  and torch.equal(got[0].nan_to_num(), want[0].nan_to_num()),
                  f"cfc_solve {key}: the parent's kernel gives the same bits")
        ms, parent_ms = in_turns(kern, old)
        bnd, by = cfc_bound_ms(M, n, logf.element_size(), total)
        prefix = "" if key == "config3" else f"{key}_"
        row = {f"{prefix}ms": ms, f"{prefix}parent_ms": parent_ms,
               f"{prefix}bound_ms": bnd, f"{prefix}iterations": total,
               f"{prefix}most": most,
               f"{prefix}us_per_iteration": ms * 1e3 / most if most else None}
        if key == "config3":
            host = (time_ms(kern, 50) + time_ms(kern, 50)) / 2
            plain = [time_ms(lambda: cfc._solve_marginals(
                logf, logg, tr, maxiter, precision, frozen=frozen, exact=True), 3)
                for _ in range(2)]
            row.update(host_ms=host, plain_ms=sum(plain) / 2, bound_by=by,
                       shape=list(logf.shape))
        out["cfc_solve"].update(row)
        print(f"time cfc_solve {key} {tuple(logf.shape)} float32 ({name_limit}): "
              f"device {nums(ms)} [parent {nums(parent_ms)}], bound "
              f"{nums(bnd, 6)} ({by}; {total} iterations over {M} slots), "
              f"{bnd / ms:.2%} of bound; longest row {most} iterations"
              + (f", {ms * 1e3 / most:.4f} us of device time per iteration"
                 if most else "")
              + (f"; host {row['host_ms'] * 1e3:.2f} us per wrapper call, "
                 f"plain {row['plain_ms']:.3f} ms" if key == "config3" else ""),
              flush=True)
    out["cfc_solve"].update(max_abs_err=max_abs, max_ulp_f32=max(ulps),
                            max_rel_f64=max(rels))

    # the gamma kernel: config 3's scout call that draws most, sample()'s,
    # the degenerate case; beside each torch._standard_gamma
    rounds = {}

    def drawn(rec):
        key = id(rec)
        if key not in rounds:
            rounds[key] = gamma_rounds(*rec)
        return rounds[key]

    cases = {
        "config3": max((r for r in scout if r[0].shape == d0.shape),
                       key=lambda r: drawn(r)[0]),
        "sample": max(gammas["README sample()"], key=lambda r: drawn(r)[0]),
        "degenerate": degenerate,
    }
    for key, rec in cases.items():
        d, c, keys = rec
        total, most, lane_rounds = drawn(rec)
        streams = LaneRNG(keys, torch.zeros((), dtype=torch.bool, device=DEVICE))

        def kern():
            return dirichlet.gamma_accept(d, c, streams)
        old = None
        if "gamma_accept" in parent:
            old = parent_gamma(parent["gamma_accept"], d, c, keys)
            got, flag = old()
            check(torch.equal(got, kern()) and not bool(flag),
                  f"gamma_accept {key}: the parent's kernel gives the same bits")
        ms, parent_ms = in_turns(kern, old)
        check(not bool(streams.exhausted),
              "gamma_accept: the timed calls accepted all")
        a = d + 1.0 / 3.0
        library = device_ms(lambda: torch._standard_gamma(a))
        bnd, by, parts = gamma_bound_ms(d, keys, total, lane_rounds)
        prefix = "" if key == "config3" else f"{key}_"
        row = {f"{prefix}ms": ms, f"{prefix}parent_ms": parent_ms,
               f"{prefix}bound_ms": bnd, f"{prefix}library_ms": library,
               f"{prefix}rounds": total, f"{prefix}most": most,
               f"{prefix}bound_float_int_bytes_ms": list(parts)}
        if key == "config3":
            host = (time_ms(kern, 50) + time_ms(kern, 50)) / 2
            plain = [time_ms(lambda: dirichlet._gamma_accept(d, c, LaneRNG(keys)), 3)
                     for _ in range(2)]
            lib_host = (time_ms(lambda: torch._standard_gamma(a), 50)
                        + time_ms(lambda: torch._standard_gamma(a), 50)) / 2
            row.update(host_ms=host, plain_ms=sum(plain) / 2, bound_by=by,
                       library_host_ms=lib_host, shape=list(d.shape))
        out["gamma_accept"].update(row)
        print(f"time gamma_accept {key} {tuple(d.shape)} float32 ({name_limit}): "
              f"device {nums(ms)} [parent {nums(parent_ms)}], "
              f"torch._standard_gamma {nums(library)}, bound {nums(bnd, 6)} "
              f"({by}; float {nums(parts[0], 6)}, integer hashing "
              f"{nums(parts[1], 6)}, bytes {nums(parts[2], 6)}; {total} rounds "
              f"over {d.numel()} entries, at most {most}, {lane_rounds} "
              f"lane-rounds), {bnd / ms:.2%} of bound"
              + (f"; host {row['host_ms'] * 1e3:.2f} us per wrapper call "
                 f"(torch._standard_gamma {lib_host * 1e3:.2f} us), plain "
                 f"{row['plain_ms']:.3f} ms" if key == "config3" else ""),
              flush=True)
    out["gamma_accept"].update(max_abs_err=g_abs, max_ulp=max(g_ulps),
                               not_bit_equal=differ)
    return out


# host-side calls that put work on the device, as torch.profiler names them
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "MemcpyAsync", "MemsetAsync")


# the hand kernels' names in a trace (csrc/*.cu)
KERNEL_NAMES = ("kalman_sym_kernel", "kalman_sym_cluster_kernel", "kalman_sym_split_kernel",
                "kalman_dense_kernel", "cfc_solve_kernel", "gamma_accept_kernel")


def graph_profile(run):
    """One call of ``run`` traced by torch.profiler (CUDA activity only,
    read from its raw events: a fraction of the full trace's cost at
    thousands of launches per step): ``(device ms, profiled wall s, host
    launch calls (`LAUNCH_CALLS`), its result, {kernel name: (launches,
    device ms)} of the hand kernels (`KERNEL_NAMES`))``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ns = calls = 0
    kernels = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ns += e.duration_ns()
            name = next((k for k in KERNEL_NAMES if k in e.name()), None)
            if name is not None:
                n, ns = kernels.get(name, (0, 0))
                kernels[name] = (n + 1, ns + e.duration_ns())
        elif any(k in e.name() for k in LAUNCH_CALLS):
            calls += 1
    return (busy_ns / 1e6, wall, calls, out,
            {k: (n, ns / 1e6) for k, (n, ns) in kernels.items()})


def same_bits(a, b, fields):
    """Whether results ``a`` and ``b`` hold the same bits in ``fields``
    (arrays, or lists of arrays per trajectory)."""
    def eq(x, y):
        if isinstance(x, list):
            return len(x) == len(y) and all(eq(u, v) for u, v in zip(x, y))
        return np.array_equal(x, y, equal_nan=np.asarray(x).dtype.kind == "f")
    return all(eq(getattr(a, f), getattr(b, f)) for f in fields)


def same_sample(a, b):
    """Whether two `sample()` results hold the same bits: every sampler's
    evidences and state (`AmisState.to_numpy`), the best profile and the
    evidence-averaged log marginal posterior."""
    def state(s):
        return s.state.to_numpy() if hasattr(s, "_lane") else {}

    if len(a.samplers) != len(b.samplers):
        return False
    for x, y in zip(a.samplers, b.samplers):
        sx, sy = state(x), state(y)
        if x.evidences != y.evidences or sx.keys() != sy.keys() or not all(
                np.array_equal(sx[f], sy[f],
                               equal_nan=np.asarray(sx[f]).dtype.kind == "f")
                for f in sx):
            return False
    return (np.array_equal(np.asarray(a.best_profile()[:]),
                           np.asarray(b.best_profile()[:]))
            and np.array_equal(a.log_marginal_posterior(dE="average"),
                               b.log_marginal_posterior(dE="average")))


def readme_case(bt):
    """The README's `sample()` case: ``(model, true profile, trajectory)``,
    MultiStateRouse(N=20, D=1, k=5, d=3, localization_error=0.1) and a
    T=100 trajectory with a loop at frames 30-60."""
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    true = np.zeros(T, dtype=int)
    true[30:60] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator(device=DEVICE).manual_seed(42))
    return model, true, traj


def ggm_sample_case(bt):
    """The `ggm_model` example's `sample()`: its model (`bench_e2e_torch.
    ggm_model`), its first trajectory (T=100, a loop at frames 30-60, numpy
    seed 0), k_max=20 with informed init, generator seed 1. Returns ``(run,
    true profile)``."""
    model = ggm_model(device=DEVICE)
    true = np.zeros(T, dtype=int)
    true[30:60] = 1
    traj = model.trajectory_from_loopingprofile(true,
                                                rng=np.random.default_rng(0))

    def run():
        return bt.sample(traj, model, k_max=20,
                         generator=torch.Generator(device=DEVICE).manual_seed(1),
                         sampler_kw={"informed_init": True})
    return run, true


def graph_cases(bt):
    """The runs of the graph phase: ``(label, selector, run, same(a, b) ->
    whether two results hold the same bits, score(result) -> (frame,
    switch-count accuracy), bars)``."""
    from bild_tpu_torch.parallel import sample_batch, sample_dataset

    m3 = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM, localization_error=0.1,
                                   device=DEVICE, dtype=torch.float32)
    truths3, k3, _, trajs3 = config3_data(m3, 128, T)
    m4 = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                   looppositions=THREE_STATES,
                                   localization_error=0.1, device=DEVICE,
                                   dtype=torch.float32)
    truths4, k4, batch4 = config4_data(m4)
    lock = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
                scout_steps=4, refine_top=3, marginals=True,
                optimize_boundaries=True, chunk_size=64)
    adap = dict(k_max=4, N=128, informed_init=True, init_steps=4,
                steps_per_round=2, max_steps_per_k=24, samplesize=4096,
                schedule="adaptive", chunk_size=128)

    def score_list(truths, true_k):
        return lambda r: (float(np.mean(np.concatenate(r.best_profile())
                                        == truths.ravel())),
                          float(np.mean(r.best_k() == true_k)))

    def score(truths, true_k):
        return lambda r: (float(np.mean(r.best_profile() == truths)),
                          float(np.mean(r.best_k() == true_k)))

    def fields(*names):
        return lambda a, b: same_bits(a, b, names)

    ds = ("evidence", "evidence_se", "profiles_by_k", "mom_ok")
    sb = fields("evidence", "evidence_se", "map_profiles", "mom_ok")
    bars3 = (DATASET_FRAME_ACCURACY, DATASET_SWITCH_ACCURACY)
    cases = []
    for sel in ("auto", "sym", "dense"):
        cases.append((
            "config 3 lockstep", sel,
            lambda: sample_dataset(m3, trajs3, **lock,
                                   generator=torch.Generator().manual_seed(7)),
            fields(*ds, "marginals", "optimized"), score_list(truths3, k3), bars3))
        cases.append((
            "config 3 adaptive", sel,
            lambda: sample_dataset(m3, trajs3, **adap,
                                   generator=torch.Generator().manual_seed(7)),
            fields(*ds, "evals"), score_list(truths3, k3), bars3))
    for sel in ("auto", "sym", "dense"):
        cases.append((
            "config 4", sel,
            lambda: sample_batch(m4, batch4, **CONFIG4_KW,
                                 generator=torch.Generator().manual_seed(4)),
            sb, score(truths4, k4),
            (CONFIG4_FRAME_ACCURACY, CONFIG4_SWITCH_ACCURACY)))
    # sample(): one trajectory, every sampler one lane of the same graph
    mr, true_r, traj_r = readme_case(bt)

    def score_sample(true):
        return lambda r: (float(np.mean(np.asarray(r.best_profile()[:]) == true)),
                          float(r.best_k() == switch_counts(true[None])[0]))

    for sel in ("auto", "sym", "dense"):
        cases.append((
            "README sample()", sel,
            lambda: bt.sample(traj_r, mr,
                              generator=torch.Generator(device=DEVICE).manual_seed(7)),
            same_sample, score_sample(true_r), (SLICE_ACCURACY, 0.0)))
    run_g, true_g = ggm_sample_case(bt)
    cases.append(("ggm sample()", "sym", run_g, same_sample, score_sample(true_g),
                  (EXAMPLE_REFERENCE["ggm_model"]["single_accuracy"] - EXAMPLE_SLACK,
                   0.0)))
    for number in (6, 7):
        model, truths, true_k, _, batch = ggm_config(bt, number)
        informed, bar_f, bar_s = GGM_CONFIGS[number][3:]
        cases.append((
            f"ggm config {number}", "sym",
            lambda model=model, batch=batch, informed=informed, seed=number:
            sample_batch(model, batch, **GGM_KW, informed_init=informed,
                         generator=torch.Generator().manual_seed(seed)),
            sb, score(truths, true_k), (bar_f, bar_s)))
    return cases


def graph_phase(bt):
    """The AMIS step as one CUDA graph (`parallel.graphs`) against the
    eager step (``graphs._EAGER``), in one call: config 3's lockstep
    `sample_dataset` (chunks of 64, marginals, the climb) and adaptive
    schedule under each selector, config 4 under each, the README
    `sample()` under each, the `ggm_model` example's `sample()`, GGM
    configs 6 and 7. Per run and mode: the wall (graphed: the run after
    the capturing one), the device-busy share and the host launch calls per
    AMIS step of a traced run, captures and replays, the gamma sampler's
    exhaustion counter, and the peak device memory allocated and reserved.
    Checks: graphed equals eager bit for bit (evidences, MAP profiles,
    mom_ok; marginals and climbed profiles, evaluations; for `sample()`
    every sampler's evidences and state, the best profile and the
    averaged marginal posterior), the traced runs too; every accuracy bar;
    the eager runs replay nothing, the graphed ones replay and launch the
    selected kernel, csrc/cfc_solve.cu and csrc/gamma_accept.cu, and no
    plain version runs; a `sample()` captures one graph, and a second one
    of the same shapes none; a step that reads the host fails to capture
    and raises. Returns ``{"launches": {"cfc_solve": ..., "gamma_accept":
    ...}, "runs": ...}`` (the graphed runs' launches)."""
    from bild_tpu_torch.amis.dirichlet import standard_gamma
    from bild_tpu_torch.parallel import graphs
    from bild_tpu_torch.parallel.batch import run_steps

    found = bt.config.rouse_kernel()
    t_phase = time.perf_counter()
    launches, runs = {"cfc_solve": 0, "gamma_accept": 0}, {}
    for label, sel, run, same_run, score, bars in graph_cases(bt):
        bt.config.set_rouse_kernel(sel)
        got = {}
        for mode in ("eager", "graphed"):
            graphs._EAGER = mode == "eager"
            try:
                graphs.clear()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                first = None
                if mode == "graphed":
                    caps = graphs.replay.captures
                    t0 = time.perf_counter()
                    first = run()
                    torch.cuda.synchronize()
                    first_wall = time.perf_counter() - t0
                    caps = graphs.replay.captures - caps
                torch.cuda.reset_peak_memory_stats()
                counters.reset()
                run_steps.steps = 0
                reps, copies = graphs.replay.replays, graphs.replay.copies
                caps_again = graphs.replay.captures
                exhausted = standard_gamma.exhausted
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                ran = counters.read()
                info = {
                    "wall_s": wall, "steps": run_steps.steps,
                    "replays": graphs.replay.replays - reps,
                    "copies_per_step": ((graphs.replay.copies - copies)
                                        / max(run_steps.steps, 1)),
                    "captures_again": graphs.replay.captures - caps_again,
                    "gamma_exhausted": standard_gamma.exhausted - exhausted,
                    "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
                    "launches": ran}
                if mode == "graphed":
                    info.update(first_wall_s=first_wall, captures=caps)
                steps0 = run_steps.steps
                dev_ms, traced_wall, calls, traced, kern = graph_profile(run)
                info.update(
                    kernel_device_us={k: ms * 1e3 / n for k, (n, ms) in kern.items()},
                    device_ms=dev_ms, traced_wall_s=traced_wall,
                    busy_share=dev_ms / 1e3 / traced_wall,
                    busy_of_wall=dev_ms / 1e3 / wall,
                    launch_calls_per_step=calls / max(run_steps.steps - steps0, 1))
            finally:
                graphs._EAGER = False
            got[mode] = (res, first, traced, info)
        res, first, traced, _ = got["graphed"]
        eager = got["eager"][0]
        acc, sw = score(res)
        same = same_run(res, eager)
        e, g = got["eager"][3], got["graphed"][3]
        key = f"{label} {sel}"
        runs[key] = {"eager": e, "graphed": g, "frame_accuracy": acc,
                     "switch_accuracy": sw, "graphed_equals_eager": same}
        def busy(i):
            return (f"busy {i['busy_share']:.4f} ({i['device_ms']:.1f} ms of "
                    f"{i['traced_wall_s']:.3f} s traced; {i['busy_of_wall']:.4f} "
                    "of the untraced wall)" if i["device_ms"] > 0
                    else "busy not measured (no device events in the trace)")

        print(f"graph {key}: eager wall {e['wall_s']:.3f} s, {busy(e)}, "
              f"{e['launch_calls_per_step']:.1f} host launch calls per step "
              f"({e['steps']} steps), peak {e['peak_allocated_gib']:.2f} / "
              f"{e['peak_reserved_gib']:.2f} GiB allocated / reserved | graphed "
              f"wall {g['wall_s']:.3f} s (the capturing run {g['first_wall_s']:.3f} "
              f"s, {g['captures']} captures), {busy(g)}, "
              f"{g['launch_calls_per_step']:.1f} host launch calls per step "
              f"({g['steps']} steps, {g['replays']} replayed; "
              f"{g['copies_per_step']:.1f} tensors copied into and out of the "
              f"graph's buffers per step, among those calls), peak "
              f"{g['peak_allocated_gib']:.2f} / {g['peak_reserved_gib']:.2f} GiB; "
              f"gamma exhausted {e['gamma_exhausted'] + g['gamma_exhausted']}; "
              f"launches and plain calls {g['launches']}; device us per "
              f"launch (graphed, traced) " + ", ".join(
                  f"{k} {v:.1f}" for k, v in g["kernel_device_us"].items())
              + f"; frame "
              f"accuracy {acc:.4f}, switch-count accuracy {sw:.4f}; graphed "
              f"equals eager bit for bit: {same}", flush=True)
        check(same, f"graph {key}: graphed equals eager bit for bit")
        check(same_run(first, res) and same_run(traced, res)
              and same_run(got["eager"][2], eager),
              f"graph {key}: every run from the same seed gives the same bits")
        check(acc >= bars[0] and sw >= bars[1],
              f"graph {key}: accuracy {acc:.4f} / {sw:.4f} >= {bars}")
        check(e["replays"] == 0 and g["replays"] > 0 and g["captures"] > 0,
              f"graph {key}: eager replays nothing, graphed replays its captures")
        check(g["launches"]["cfc_solve"] > 0 and g["launches"]["gamma_accept"] > 0,
              f"graph {key}: the CFC and gamma kernels ran")
        check(all(v == 0 for i in (e, g) for k, v in i["launches"].items()
                  if k.startswith("plain")),
              f"graph {key}: no plain version ran, eager or graphed")
        check(label.startswith("ggm")
              or g["launches"][launched_kernel(sel, label)] > 0,
              f"graph {key}: {launched_kernel(sel, label)} launched")
        check(e["gamma_exhausted"] == g["gamma_exhausted"] == 0,
              f"graph {key}: every gamma draw accepted within its rounds")
        if "adaptive" in label:
            check(float(np.mean(res.evals)) < LOCKSTEP_EVALS,
                  f"graph {key}: fewer evaluations than the lockstep schedule")
        if label.endswith("sample()"):
            check(g["captures"] == 1 and g["captures_again"] == 0,
                  f"graph {key}: one sample() captures one graph, a second "
                  f"none ({g['captures']}, {g['captures_again']})")
        launches["cfc_solve"] += g["launches"]["cfc_solve"]
        launches["gamma_accept"] += g["launches"]["gamma_accept"]
    cost = copy_cost(bt)
    runs["README sample() copies"] = cost
    print(f"graph copies: the README sample()'s step graph ('sym'), per "
          f"steps(n) call: {cost['copies']} tensors ({cost['bytes']} bytes) "
          f"copied in and out, {cost['host_us']:.1f} us on the host to issue "
          f"them, {cost['wall_us']:.1f} us with the device, "
          f"{cost['device_us']:.1f} us of device time, "
          f"{cost['traced_calls']:.1f} host launch calls in their trace",
          flush=True)
    bt.config.set_rouse_kernel(found)
    check(capture_refuses_host_reads(bt),
          "graph: a sampler step that reads the host fails to capture and raises")
    print(f"graph phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "runs": runs}


def copy_cost(bt, reps=100):
    """The copies into and out of the buffers of the README `sample()`'s
    step graph ('sym') that `parallel.graphs` makes on every `steps(n)`
    call of a sampler, per call: the tensors and bytes copied, the host's
    microseconds to issue them, the wall with the device's, the device's
    microseconds and the host launch calls a trace of them counts
    (`graph_profile`). Timed as ``run(..., 0)`` of the cached graph: the
    copies of a call without its replay."""
    from bild_tpu_torch.parallel import graphs

    model, _, traj = readme_case(bt)
    found = bt.config.rouse_kernel()
    bt.config.set_rouse_kernel("sym")
    graphs.clear()
    bt.sample(traj, model, generator=torch.Generator(device=DEVICE).manual_seed(7))
    (graph,) = graphs._GRAPHS.values()
    mutable = [t.clone() for t in graph.mutable]
    inputs = [t.clone() for t in graph.inputs]

    def copies():
        for _ in range(reps):
            graph.run(mutable, inputs, 0)

    copies()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copies()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_ms, _, calls, _, _ = graph_profile(copies)
    graphs.clear()
    bt.config.set_rouse_kernel(found)
    tensors = [*graph.inputs, *graph.mutable, *graph.mutable]
    return {"copies": len(tensors),
            "bytes": sum(t.numel() * t.element_size() for t in tensors),
            "host_us": host / reps * 1e6, "wall_us": wall / reps * 1e6,
            "device_us": dev_ms * 1e3 / reps, "traced_calls": calls / reps}


def capture_refuses_host_reads(bt):
    """Whether a `FixedkSampler` whose likelihood reads a value back to the
    host (a ``float()`` of a device tensor) raises on its step's capture,
    after its eager first step, with no quiet fallback to the eager loop."""
    from bild_tpu_torch.amis.sampler import FixedkSampler
    from bild_tpu_torch.parallel import graphs

    model, _, traj = readme_case(bt)
    s = FixedkSampler(traj, model, k=3,
                      generator=torch.Generator(device=DEVICE).manual_seed(3))
    real = s._logL_fn

    def reading(profiles, lane_data):
        float(profiles.sum())
        return real(profiles, lane_data)

    s._logL_fn = reading
    graphs.clear()
    replays = graphs.replay.replays
    try:
        s.steps(3)
    except RuntimeError as e:
        print(f"graph: a step that reads the host: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:120]}", flush=True)
        return graphs.replay.replays == replays
    finally:
        graphs.clear()
        torch.cuda.synchronize()
    return False


# config 5 with post-processing: bild_tpu recorded 0.9926 / 0.8897, after
# the boundary climb 0.9927, mean credibility 0.9937 (PERF_r04.json, 5p)
CONFIG5_CHUNKS, CONFIG5_CHUNK = 10, 1024
CONFIG5_CREDIBILITY = 0.97
CONFIG5_KW = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
                  scout_steps=4, refine_top=3, marginals=True)


def config5p_phase(bt):
    """bench_e2e.py ``config5(postproc=True)`` at full size under the
    default selector: `CONFIG5_CHUNKS` chunks of 1,024 trajectories of T=100
    (truths from one numpy Generator seeded 5, data made on the card per
    chunk), each `sample_batch(k_max=4, steps_per_k=12, N=128,
    informed_init, scout_steps=4, refine_top=3, marginals)`, the boundary
    climb on the MAP profiles and the evidence-averaged marginal
    credibility of the climbed profiles. Bars: frame and switch-count
    accuracy as config 3's, the climb costs no more than 0.001 of frame
    accuracy, credibility `CONFIG5_CREDIBILITY`; the kernel ran and no
    plain version. Reports the wall, trajectories per second, the first
    and the steady chunks' seconds and the peak device memory."""
    from bild_tpu_torch.parallel import sample_batch
    from bild_tpu_torch.postproc import optimize_boundary_batch

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    rng = np.random.default_rng(5)
    acc = sw = acc_post = cred = 0.0
    chunk_s, finite = [], True
    from bild_tpu_torch.parallel import graphs

    counters.reset()
    caps, reps = graphs.replay.captures, graphs.replay.replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for c in range(CONFIG5_CHUNKS):
        tc = time.perf_counter()
        truths = truth_profiles(rng, CONFIG5_CHUNK, T, 2)
        true_k = np.sum(truths[:, 1:] != truths[:, :-1], axis=1)
        batch = model.trajectories_from_loopingprofiles(
            truths, generator=torch.Generator(device=DEVICE).manual_seed(100 + c))
        res = sample_batch(model, batch, **CONFIG5_KW,
                           generator=torch.Generator().manual_seed(200 + c))
        profiles = res.best_profile()
        acc += float(np.mean(profiles == truths))
        sw += float(np.mean(res.best_k() == true_k))
        opt, _ = optimize_boundary_batch(profiles, batch, model)
        acc_post += float(np.mean(opt == truths))
        logpost = res.log_marginal_posterior(dE="average")       # (B, n, T)
        with np.errstate(under="ignore"):
            picked = np.take_along_axis(np.exp(logpost), opt[:, None, :], axis=1)
        cred += float(np.mean(picked))
        finite = finite and bool(np.all(np.isfinite(res.evidence))
                                 and res.mom_ok.all())
        chunk_s.append(time.perf_counter() - tc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = counters.read()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = CONFIG5_CHUNKS
    acc, sw, acc_post, cred = acc / n, sw / n, acc_post / n, cred / n
    B = n * CONFIG5_CHUNK
    steady = float(np.median(chunk_s[1:])) if n > 1 else float("nan")
    print(f"config 5p: {n} chunks of {CONFIG5_CHUNK} (B={B}, T={T}; matmul tier "
          f"{bt.config.resolve_matmul('lockstep', T=T)!r}): wall "
          f"{wall:.3f} s, {B / wall:.2f} trajectories/s, first chunk "
          f"{chunk_s[0]:.3f} s, steady chunk (median of the rest) {steady:.3f} s "
          f"(each: {', '.join(f'{x:.2f}' for x in chunk_s)}), frame accuracy "
          f"{acc:.4f}, switch-count accuracy {sw:.4f}, after the boundary climb "
          f"{acc_post:.4f}, mean credibility {cred:.4f}, peak device memory "
          f"{peak:.2f} GiB allocated, "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved, "
          f"launches {ran}; step graphs: {graphs.replay.captures - caps} "
          f"captures, {graphs.replay.replays - reps} replayed steps", flush=True)
    kernel = launched_kernel(bt.config.rouse_kernel(), "config 5p")
    check(ran[kernel] > 0, f"{kernel} launched")
    check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
          "no plain version ran on the CUDA path")
    check(finite, "every evidence finite, CFC converged in every lane")
    check(acc >= DATASET_FRAME_ACCURACY,
          f"config 5p frame accuracy {acc:.4f} >= {DATASET_FRAME_ACCURACY}")
    check(sw >= DATASET_SWITCH_ACCURACY,
          f"config 5p switch-count accuracy {sw:.4f} >= {DATASET_SWITCH_ACCURACY}")
    check(acc_post >= acc - 0.001,
          f"climbed frame accuracy {acc_post:.4f} >= unclimbed {acc:.4f} - 0.001")
    check(cred >= CONFIG5_CREDIBILITY,
          f"mean credibility {cred:.4f} >= {CONFIG5_CREDIBILITY}")
    return ran


# What bild_tpu's examples printed at full size on the CPU (examples/*.py,
# JAX_PLATFORMS=cpu; PERF.md section 5), and the port's bars from them:
# accuracies no more than 0.03 below; fitted parameters no farther from the
# truth than bild_tpu's fit plus a tenth of the true value.
EXAMPLE_REFERENCE = {
    "single_trajectory": {"frame_accuracy": 1.0},
    # truths [20 0 44 0 0] over k; bild_tpu's histogram [21 1 39 0 3]
    # shares 59 of 64 trajectories with them
    "infer_dataset": {"histogram_overlap": 59 / 64},
    "calibrate_params": {"frame_accuracy": 0.990, "D": 0.971, "k": 5.258},
    "ggm_model": {"guess_accuracy": 0.62, "single_accuracy": 0.91,
                  "dataset_accuracy": 0.932,
                  "parameters": [{"G": 0.989, "J": 4.753},
                                 {"G": 0.187, "J": 0.792}]},
}
EXAMPLE_TRUTH = {"D": 1.0, "k": 5.0,
                 "parameters": [{"G": 1.0, "J": 5.0}, {"G": 0.2, "J": 1.0}]}
EXAMPLE_SLACK = 0.03


def example_bars(name, out):
    """``[(what, value, bar, met)]`` of one example's returned dict."""
    ref, bars = EXAMPLE_REFERENCE[name], []

    def at_least(what, value, bar):
        bars.append((what, value, bar, value >= bar))

    def near(what, value, truth, ref_value):
        bar = abs(ref_value - truth) + 0.1 * abs(truth)
        bars.append((f"|{what} - {truth}|", abs(value - truth), bar,
                     abs(value - truth) <= bar))

    if name == "single_trajectory":
        at_least("frame accuracy", out["frame_accuracy"],
                 ref["frame_accuracy"] - EXAMPLE_SLACK)
    elif name == "infer_dataset":
        true_hist = np.array([20, 0, 44, 0, 0])
        overlap = np.minimum(out["k_histogram"][:5], true_hist).sum() / 64
        at_least("frame accuracy against the truths", out["frame_accuracy"],
                 DATASET_FRAME_ACCURACY)
        at_least("k histogram shared with the truths", overlap,
                 ref["histogram_overlap"] - EXAMPLE_SLACK)
    elif name == "calibrate_params":
        at_least("frame accuracy", out["frame_accuracy"],
                 ref["frame_accuracy"] - EXAMPLE_SLACK)
        for p in ("D", "k"):
            near(p, out[p], EXAMPLE_TRUTH[p], ref[p])
    else:
        for what in ("guess_accuracy", "single_accuracy", "dataset_accuracy"):
            at_least(what, out[what], ref[what] - EXAMPLE_SLACK)
        for i, (got, want, truth) in enumerate(zip(
                out["parameters"], ref["parameters"], EXAMPLE_TRUTH["parameters"])):
            for p in ("G", "J"):
                near(f"state {i} {p}", got[p], truth[p], want[p])
    return bars


class IIDGaussianModel:
    """The user-defined model of tests/test_custom_model.py (two states,
    state s emits N(mu_s, 1) per frame) on the card: only ``nStates``,
    ``transitions``, ``logL_batch`` and the optional ``device`` and
    ``dtype``. With ``host=True`` it computes in numpy on the host and
    returns a numpy array."""

    def __init__(self, host):
        self.host, self.calls = host, 0
        self.mus = np.array([0.0, 3.0])
        self.nStates = 2
        self.transitions = ~np.eye(2, dtype=bool)
        self.device, self.dtype = DEVICE, torch.float32

    def logL_batch(self, profiles, traj):
        self.calls += 1
        if self.host:
            y = traj.data[:, 0].cpu().numpy().astype(float)
            mu = self.mus[profiles.cpu().numpy()]
            valid = traj.valid.cpu().numpy()
            return (-0.5 * ((y[None] - mu) ** 2 + np.log(2 * np.pi))
                    * valid[None]).sum(axis=1)
        mus = torch.as_tensor(self.mus, dtype=traj.data.dtype, device=traj.data.device)
        mu = mus[profiles.long()]
        return (-0.5 * ((traj.data[None, :, 0] - mu) ** 2 + np.log(2 * np.pi))
                * traj.valid[None]).sum(dim=1)


def examples_phase(bt):
    """Each of bild_tpu_torch's four examples at full size on the card,
    in this process (`main()` with no device: the GPU), against the bars of
    `example_bars`; the launch counters: the Rouse examples ran the sym
    kernel and no plain version outside the calibration's M-step
    (`fit.calibration_logL.calls`, counted apart), the GGM example ran no
    Rouse recursion at all. Then the user-defined `IIDGaussianModel`
    through `sample()` on the card, returning a tensor and a numpy array.
    Returns the summed counters."""
    import importlib

    from bild_tpu_torch import fit

    found = bt.config.rouse_kernel()
    bt.config.set_rouse_kernel("sym")
    totals = {}
    for name in ("single_trajectory", "infer_dataset", "calibrate_params",
                 "ggm_model"):
        mod = importlib.import_module(f"bild_tpu_torch.examples.{name}")
        counters.reset()
        fit.calibration_logL.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.main()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = counters.read()
        ran["calibration_plain"] = fit.calibration_logL.calls
        bars = example_bars(name, out)
        print(f"example {name}: wall {wall:.3f} s, bars "
              + "; ".join(f"{w} {v:.4f} (bar {b:.4f}{'' if ok else ', MISSED'})"
                          for w, v, b, ok in bars)
              + f", counters {ran}", flush=True)
        for w, v, b, ok in bars:
            check(ok, f"example {name}: {w} {v:.4f} against {b:.4f}")
        check(ran["plain_gamma"] == ran["plain_cfc"] == 0,
              f"example {name}: the gamma and CFC kernels, no plain version")
        if name == "ggm_model":
            check(all(ran[k] == 0 for k in ROUSE_COUNTERS),
                  f"the GGM example ran no Rouse recursion: {ran}")
        else:
            check(ran["kalman_sym"] > 0, f"example {name}: the sym kernel launched")
            check(ran["plain_sym"] == ran["plain_dense"] == 0
                  and ran["plain_torch"] == ran["calibration_plain"],
                  f"example {name}: plain likelihoods only in the calibration's M-step")
        for k, v in ran.items():
            totals[k] = totals.get(k, 0) + v

    # a user-defined model on the card: a tensor and a numpy array returned
    rng = np.random.default_rng(7)
    true = np.zeros(20, dtype=int)
    true[8:14] = 1
    y = np.array([0.0, 3.0])[true] + 0.6 * rng.normal(size=20)
    results = {}
    for host in (False, True):
        model = IIDGaussianModel(host)
        res = bt.sample(y, model, k_max=4,
                        generator=torch.Generator(device=DEVICE).manual_seed(11))
        acc = float(np.mean(np.asarray(res.best_profile()[:]) == true))
        kind = "numpy" if host else "tensor"
        results[kind] = res
        print(f"custom model returning a {kind}: {model.calls} logL_batch calls, "
              f"best_k {res.best_k()}, frame accuracy {acc:.3f}, evidence "
              f"{np.round(res.evidence, 4).tolist()}", flush=True)
        check(model.calls > 0 and res.samplers[-1].state.logLs.is_cuda,
              f"custom model ({kind}): the fallback ran, its state on the card")
        check(np.all(np.isfinite(res.evidence)) and acc > 0.85,
              f"custom model ({kind}): finite evidences, accuracy {acc:.3f} > 0.85")
    # k = 0, 1, 2 are enumerated exhaustively: the same up to float32
    ev_t, ev_n = (results[k].evidence[:3] for k in ("tensor", "numpy"))
    check(np.allclose(ev_t, ev_n, rtol=1e-5),
          f"exhaustive evidences agree across return types: {ev_t} {ev_n}")
    bt.config.set_rouse_kernel(found)
    return totals


# runs `python -m bild_tpu_torch` (runpy is what -m uses) and writes the
# launch, parse and checkpoint-commit counters and the peak device memory
# of that process to the path given first
CLI_RUNNER = """
import atexit, json, os, runpy, sys
import torch
import bild_tpu_torch
from bild_tpu_torch import fit, io
from bild_tpu_torch.ops import counters
out = sys.argv.pop(1)
writes = []
_replace = os.replace
def counting_replace(src, dst):
    if os.path.basename(dst).startswith(("chunk_", "shard_chunk_")):
        writes.append(dst)
    return _replace(src, dst)
os.replace = counting_replace
atexit.register(lambda: json.dump({
    "checkpoint_writes": len(writes),
    "peak_device_gib": (torch.cuda.max_memory_allocated() / 2**30
                        if torch.cuda.is_available() else 0.0),
    **counters.read(),
    "calibration_plain": fit.calibration_logL.calls,
    "native_parses": io.load_trajectories_csv.native_parses}, open(out, "w")))
runpy.run_module("bild_tpu_torch", run_name="__main__", alter_sys=True)
"""


def write_two_locus_csv(path, batch, rows):
    """Trajectories ``rows`` of ``batch`` as a two-locus CSV (``traj_id``
    the row): the first locus at a random point, the second at it plus the
    trajectory."""
    rel = batch.data.cpu().numpy().astype(np.float64)
    base = np.random.default_rng(5).normal(size=(len(rel), 1, DIM)) * 3.0
    with open(path, "w") as f:
        f.write("traj_id,frame,x1,y1,z1,x2,y2,z2\n")
        for i in rows:
            for t in range(T):
                a, b = base[i, 0], base[i, 0] + rel[i, t]
                f.write(f"{i},{t}," + ",".join(repr(float(v)) for v in (*a, *b))
                        + "\n")


def cli_phase(bt, work):
    """Config 3 as a two-locus CSV through ``python -m bild_tpu_torch`` in
    a subprocess with no ``--device`` (so on the card): the lockstep run
    with marginals, the boundary climb, dwell times and chunk checkpoints,
    a rerun (identical npz), ``--adaptive``, and ``--fit-params 1
    --fit-subset 32``. Checks accuracy from the npz against the truths,
    the native parser, and the counters: every likelihood of inference
    through the kernel, plain calls only in the calibration's M-step.
    Returns the summed counters."""
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    truths, true_k, batch, _ = config3_data(model, T=T)
    csv = os.path.join(work, "config3.csv")
    write_two_locus_csv(csv, batch, range(batch.B))
    common = [csv, "--two-locus", "--k-max", "4", "--steps-per-k", "12",
              "--proposals", "128", "--scout-steps", "4", "--refine-top", "3",
              "--chunk-size", "64", "--seed", "7", "--quiet"]
    runs = (("lockstep", ["--marginals", "--optimize-boundaries",
                          "--dwell-times", "--checkpoint-dir",
                          os.path.join(work, "ck")]),
            ("rerun", ["--marginals", "--optimize-boundaries",
                       "--dwell-times", "--checkpoint-dir",
                       os.path.join(work, "ck")]),
            ("adaptive", ["--adaptive"]),
            ("fit", ["--fit-params", "1", "--fit-subset", "32"]))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    results, totals = {}, {}
    for label, extra in runs:
        out = os.path.join(work, f"{label}.npz")
        counts = os.path.join(work, f"{label}.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, counts, *common,
                               "--out", out, *extra], capture_output=True,
                              text=True, env=env, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"CLI {label} exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        with open(counts) as f:
            ran = json.load(f)
        res = dict(np.load(out, allow_pickle=True))
        results[label] = res
        acc = float(np.mean(np.concatenate(list(res["best_profiles"]))
                            == truths.ravel()))
        sw = float(np.mean(res["best_k"] == true_k))
        extra_text = ""
        if "likelihood_evals" in res:
            extra_text = (f", evaluations per trajectory "
                          f"{res['likelihood_evals'].mean():.1f}")
        if "fitted_D" in res:
            extra_text = (f", fitted D {float(res['fitted_D']):.4f} k "
                          f"{float(res['fitted_k']):.4f}")
        print(f"cli {label}: wall {wall:.3f} s (process start to exit), frame "
              f"accuracy {acc:.4f}, switch-count accuracy {sw:.4f}"
              f"{extra_text}, counters {ran}", flush=True)
        check(ran["native_parses"] == 1, "the native CSV parser was used")
        check(ran["plain_sym"] == ran["plain_dense"] == 0
              and ran["plain_torch"] == ran["calibration_plain"],
              "plain likelihoods only in the calibration's M-step")
        check(ran["plain_gamma"] == ran["plain_cfc"] == 0,
              f"cli {label}: the gamma and CFC kernels, no plain version")
        if label != "rerun":
            kernel = launched_kernel(bt.config.rouse_kernel(), "cli")
            check(ran[kernel] > 0, f"{kernel} launched")
        if label != "fit":
            check(acc >= DATASET_FRAME_ACCURACY and sw >= DATASET_SWITCH_ACCURACY,
                  f"CLI {label} accuracy {acc:.4f} / {sw:.4f}")
        else:
            check(ran["calibration_plain"] > 0 and float(res["fitted_D"]) > 0
                  and acc >= SLICE_ACCURACY,
                  f"CLI fit ran its M-step, frame accuracy {acc:.4f}")
        for k, v in ran.items():
            totals[k] = totals.get(k, 0) + v
    first, rerun = results["lockstep"], results["rerun"]
    check(rerun["best_k"].shape == (len(truths),) and set(first) == set(rerun)
          and all(all(np.array_equal(x, y) for x, y in zip(first[k], rerun[k]))
                  if first[k].dtype == object else np.array_equal(first[k], rerun[k])
                  for k in first),
          "the CLI rerun from its checkpoints writes an identical npz")
    check(any(k.startswith("dwell_KM_state") for k in first), "dwell times")
    return totals


def checkpoint_phase(bt):
    """The README `sample()` on the card, saved and loaded: the same
    evidence and best profile, and a loaded non-exhausted sampler steps
    exactly as the uninterrupted one."""
    from bild_tpu_torch.utils import load_results, save_results

    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    true = np.zeros(T, dtype=int)
    true[30:60] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator(device=DEVICE).manual_seed(42))
    counters.reset()
    res = bt.sample(traj, model, generator=torch.Generator(device=DEVICE).manual_seed(7))
    with tempfile.TemporaryDirectory() as d:
        save_results(os.path.join(d, "ck.npz"), res)
        loaded = load_results(os.path.join(d, "ck.npz"), model)
    check(np.array_equal(res.evidence, loaded.evidence)
          and np.array_equal(np.asarray(res.best_profile()[:]),
                             np.asarray(loaded.best_profile()[:])),
          "loaded results equal the saved ones")
    i = next(i for i, s in enumerate(res.samplers) if not s.exhausted)
    for s in (res.samplers[i], loaded.samplers[i]):
        s.steps(2)
    a, b = res.samplers[i].state.to_numpy(), loaded.samplers[i].state.to_numpy()
    same = all(np.array_equal(a[f], b[f]) for f in a)
    ran = counters.read()
    print(f"checkpoint: {len(res.samplers)} samplers saved and loaded, sampler "
          f"k={res.samplers[i].k} resumed 2 steps: "
          f"{'same bits' if same else 'DIFFER'}, launches {ran}", flush=True)
    check(same and res.samplers[i].evidences == loaded.samplers[i].evidences,
          "a resumed step equals the uninterrupted one bit for bit")
    check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
          "no plain version ran on the CUDA path")
    return ran


# bench_e2e.py configs 6 and 7: (B, T, T_band, informed_init, frame bar,
# switch-count bar); bild_tpu's own runs recorded 0.929 / 0.531 and 0.990 /
# 0.875 (PERF_GGM_r05.json)
GGM_CONFIGS = {6: (64, 100, None, False, 0.88, 0.40),
               7: (16, 1000, 128, True, 0.97, 0.75)}
GGM_KW = dict(k_max=4, steps_per_k=12, N=128, scout_steps=4, refine_top=3)
RTOL_GGM_F32 = 1e-5


def ggm_parity(bt, rng):
    """The interval tables and gather-sums on the card against the float64
    host oracle: a mixed model (ss_order 0 and 1, two dims, missing frames,
    the first among them) at T=23, `logL_batch` and the lane form of
    `lockstep_fns`, in float64 (rtol 1e-9) and with float32 tables (rtol
    1e-5); the Toeplitz tables against the bucketed ones on gap-free data;
    the banded tables exact in band (T=120, band 48) and within
    `band_tail_error` beyond; a state out of range gives NaN and the
    device raises nothing."""
    import warnings

    from bild_tpu_torch.parallel import stack_trajectories

    GGM = bt.models.GenericGaussianModel

    def mixed(**kw):
        return GGM([
            [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.3, 0),
             (GGM.MSD_function_powerlaw(G=1.0, a=0.7), 0.0, 1)],
            [(GGM.MSD_function_twoLocusRouse(G=2.0, J=1.0), -0.1, 0),
             (GGM.MSD_function_powerlaw(G=0.5, a=1.0), 0.1, 1)],
        ], device=DEVICE, **kw)

    Tm = 23
    datas = rng.normal(size=(3, Tm, 2))
    datas[1, [0, 3, 4, 11]] = np.nan
    datas[2, [7, 8]] = np.nan
    profiles = rng.integers(0, 2, size=(30, Tm))
    errs = {}
    for dtype, rtol in ((torch.float64, RTOL_F64), (torch.float32, RTOL_GGM_F32)):
        model = mixed(dtype=dtype)
        trajs = [bt.Trajectory.create(d, device=DEVICE, dtype=dtype) for d in datas]
        host = np.array([[model.logL_host(p, t) for p in profiles] for t in trajs])
        single = torch.stack([model.logL_batch(profiles, t) for t in trajs])
        per_traj, fn = model.lockstep_fns(stack_trajectories(trajs), max_intervals=Tm)
        lanes = fn(torch.as_tensor(np.broadcast_to(profiles, (3, 30, Tm)).copy(),
                                   device=DEVICE), per_traj)
        check(single.is_cuda and lanes.is_cuda and per_traj[0].is_cuda
              and per_traj[0].dtype == dtype, "GGM tables and results on the card")
        for what, got in (("logL_batch", single), ("lockstep_fns", lanes)):
            err = float(np.max(rel_err(got.cpu().numpy().astype(float), host)))
            errs[(what, dtype)] = err
            check(err <= rtol, f"GGM {what} {dtype} within {rtol} of logL_host: {err:.2e}")
        bad = profiles[:3].copy()
        bad[1, 5], bad[2, -1] = 2, -1
        out = model.logL_batch(bad, trajs[1])
        torch.cuda.synchronize()
        out = out.cpu().numpy()
        check(np.isfinite(out[0]) and np.isnan(out[1:]).all(),
              "GGM: a state out of range gives NaN, the device raises nothing")

    model = mixed(dtype=torch.float64)
    full = rng.normal(size=(3, Tm, 2))
    fast = model._stationary_tables_batch(full)
    slow = model._bucketed_tables_batch(full, np.ones((3, Tm), bool))
    err_tab = float((fast - slow).abs().max())
    check(fast.is_cuda and err_tab <= 1e-9,
          f"GGM Toeplitz tables equal the bucketed ones on gap-free data: {err_tab:.2e}")

    def band_model(**kw):
        return GGM([
            [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0),
             (GGM.MSD_function_powerlaw(G=0.5, a=0.5), 0.0, 1)],
            [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.0, 0),
             (GGM.MSD_function_powerlaw(G=1.5, a=0.8), 0.1, 1)],
        ], device=DEVICE, dtype=torch.float64, **kw)

    Tb, band = 120, 48
    exact, banded = band_model(), band_model(T_band=band)
    truth = np.zeros(Tb, dtype=int)
    truth[40:80] = 1
    traj = exact.trajectory_from_loopingprofile(truth, rng=rng)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the band-error warning
        inband = abs(banded.logL(truth, traj) - exact.logL(truth, traj))
        bound = banded.band_tail_error(Tb)
        beyond = max(abs(banded.logL(p, traj) - exact.logL_host(p, traj))
                     for p in (np.zeros(Tb, int), np.ones(Tb, int)))
    check(inband <= 1e-8 * abs(exact.logL(truth, traj)),
          f"GGM banded tables exact in band: {inband:.2e}")
    check(beyond <= bound, f"GGM banded tail error {beyond:.4f} within the "
                           f"predicted {bound:.4f} nats")
    print(f"ggm parity: T={Tm} mixed model against logL_host: float64 "
          f"{errs[('logL_batch', torch.float64)]:.2e} / "
          f"{errs[('lockstep_fns', torch.float64)]:.2e}, float32 tables "
          f"{errs[('logL_batch', torch.float32)]:.2e} / "
          f"{errs[('lockstep_fns', torch.float32)]:.2e} (logL_batch / lane "
          f"lockstep_fns, max relative); Toeplitz against bucketed tables "
          f"{err_tab:.2e}; banded T={Tb} band {band}: in band {inband:.2e}, "
          f"beyond {beyond:.4f} of {bound:.4f} nats predicted", flush=True)


def ggm_config(bt, number):
    """Config 6 or 7 of bench_e2e.py at its size: ``(model, truths, true
    switch counts, trajectories, batch)``; the truths and the trajectories
    come from one numpy Generator seeded with the config's number, as
    there (`bench_e2e_torch.ggm_data`)."""
    B, Tc, T_band, _, _, _ = GGM_CONFIGS[number]
    return ggm_data(number, B, Tc, T_band, device=DEVICE)


def ggm_dataset(bt, number):
    """One GGM configuration through `sample_batch`: the table build timed
    apart from the sampling, accuracy against the bars, the same bits from
    the same seed, the device-busy share and the device time by
    operation."""
    from bild_tpu_torch.parallel import sample_batch
    from bild_tpu_torch.parallel.batch import run_lanes

    B, Tc, T_band, informed, bar_frame, bar_switch = GGM_CONFIGS[number]
    t0 = time.perf_counter()
    model, truths, true_k, trajs, batch = ggm_config(bt, number)
    made = time.perf_counter() - t0
    kw = dict(GGM_KW, informed_init=informed)

    def run():
        return sample_batch(model, batch, **kw,
                            generator=torch.Generator().manual_seed(number))

    model.clear_memo()
    first = run()                       # warm-up (and the first table build)
    walls = []
    for _ in range(2):
        model.clear_memo()              # the wall holds the table build
        run_lanes.steps = run_lanes.lane_steps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_traj, _ = model.lockstep_fns(batch)
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        res = run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0, build))
    wall, build = walls[-1]
    builds = model.table_builds
    check(builds == 3, f"one table build per clear_memo ({builds} of 3)")
    check(all(x.is_cuda and x.dtype == torch.float32 for x in per_traj),
          "GGM tables on the card, float32")
    table_bytes = sum(x.numel() * x.element_size() for x in per_traj)
    scout_lanes = (kw["k_max"] + 1) * B
    acc = float(np.mean(res.best_profile() == truths))
    sw = float(np.mean(res.best_k() == true_k))
    # float32 tables against float64: the host oracle, or with a band the
    # float64 tables of the same band (the band's own error stands apart,
    # against logL_host and within `band_tail_error`)
    nprobe = min(B, 4)
    host = np.array([model.logL_host(truths[b], trajs[b]) for b in range(nprobe)])
    dev = np.array([model.logL(truths[b], trajs[b]) for b in range(nprobe)])
    band_text = ""
    if T_band is None:
        f32_err = rel_err(dev, host)
    else:
        twin = ggm_model(T_band=T_band, device=DEVICE, dtype=torch.float64)
        dev64 = np.array([twin.logL(truths[b], trajs[b].to(dtype=torch.float64))
                          for b in range(nprobe)])
        f32_err = rel_err(dev, dev64)
        band_err, bound = float(np.max(np.abs(dev64 - host))), model.band_tail_error(Tc)
        band_text = (f"; band {T_band} against logL_host: {band_err:.4f} nats "
                     f"(predicted worst case {bound:.4f})")
        check(band_err <= bound, f"band error {band_err:.4f} within {bound:.4f} nats")
    share, top, traced = busy_share(run)
    print(f"ggm config {number}: B={B} T={Tc} T_band={T_band}: wall {wall:.3f} s "
          f"[first timed {walls[0][0]:.3f}] with the table build {build:.3f} s "
          f"[{walls[0][1]:.3f}], sampling {wall - build:.3f} s, "
          f"{B / wall:.2f} trajectories/s, {run_lanes.steps} lockstep steps "
          f"({run_lanes.lane_steps} lane-steps), frame accuracy {acc:.4f}, "
          f"switch-count accuracy {sw:.4f}; tables {table_bytes} bytes "
          f"({table_bytes // B} per trajectory), per-lane copies at the scout "
          f"launch L={scout_lanes}: {table_bytes // B * scout_lanes} bytes; "
          f"float32 tables against float64 at {nprobe} truths: "
          f"{f32_err:.2e} relative{band_text}; trajectories made on the host in "
          f"{made:.2f} s; device busy share {share}", flush=True)
    for name, (ms, cnt) in top:
        print(f"    {ms:10.1f} ms {cnt:7d}x  {name[:90]}", flush=True)
    check(acc >= bar_frame, f"config {number} frame accuracy {acc:.4f} >= {bar_frame}")
    check(sw >= bar_switch,
          f"config {number} switch-count accuracy {sw:.4f} >= {bar_switch}")
    check(f32_err <= RTOL_GGM_F32,
          f"float32 tables within {RTOL_GGM_F32} of float64: {f32_err:.2e}")
    check(np.all(np.isfinite(res.evidence)) and res.mom_ok.all(),
          "every evidence finite, CFC converged in every lane")
    for other, what in ((first, "the warm-up run"), (traced, "the traced run")):
        check(np.array_equal(other.evidence, res.evidence)
              and np.array_equal(other.map_profiles, res.map_profiles),
              f"{what} from the same seed gives the same bits")
    return model, truths, true_k, trajs, batch


def ggm_phase(bt, rng):
    """The Generic Gaussian model on the card (see the module docstring):
    table parity, configs 6 and 7 of bench_e2e.py at full size, `sample()`
    with its checkpoint, the adaptive schedule and `calibrate_ggm`. No
    Rouse kernel may launch and no Rouse plain version may run."""
    from bild_tpu_torch import fit
    from bild_tpu_torch.infer.adaptive import sample_batch_adaptive
    from bild_tpu_torch.parallel import sample_batch, sample_dataset
    from bild_tpu_torch.utils import load_results, save_results

    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ggm_parity(bt, rng)
    model, truths, true_k, trajs, batch = ggm_dataset(bt, 6)
    B = len(trajs)

    # per-k checkpointed schedule == all-k, bit for bit (no scout/refine)
    bk = dict(k_max=4, steps_per_k=12, N=128, informed_init=True, marginals=True)
    fused = sample_batch(model, batch, **bk,
                         generator=torch.Generator().manual_seed(9))
    with tempfile.TemporaryDirectory() as d:
        per_k = sample_batch(model, batch, **bk,
                             checkpoint=os.path.join(d, "ck.npz"),
                             generator=torch.Generator().manual_seed(9))
    check(all(np.array_equal(getattr(fused, f), getattr(per_k, f))
              for f in ("evidence", "evidence_se", "map_profiles", "marginals",
                        "mom_ok")),
          "GGM: per-k checkpoint path equals the fused path bit for bit")

    # the adaptive schedule on the same trajectories
    akw = dict(k_max=4, N=128, informed_init=True, init_steps=4,
               steps_per_round=2, max_steps_per_k=24, samplesize=4096)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ad = sample_dataset(model, trajs, **akw, schedule="adaptive", chunk_size=B,
                        generator=torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    ad_wall = time.perf_counter() - t0
    direct = sample_batch_adaptive(model, batch, **akw,
                                   generator=torch.Generator().manual_seed(7))
    lock_evals = GGM_KW["N"] * (GGM_KW["scout_steps"] * (GGM_KW["k_max"] + 1)
                                + (GGM_KW["steps_per_k"] - GGM_KW["scout_steps"])
                                * GGM_KW["refine_top"])
    acc = float(np.mean(np.concatenate(ad.best_profile()) == truths.ravel()))
    sw = float(np.mean(ad.best_k() == true_k))
    print(f"ggm config 6 adaptive: wall {ad_wall:.3f} s, {B / ad_wall:.2f} "
          f"trajectories/s, evaluations per trajectory mean {ad.evals.mean():.1f} "
          f"(lockstep schedule {lock_evals}), {direct.rounds} rounds, frame "
          f"accuracy {acc:.4f}, switch-count accuracy {sw:.4f}", flush=True)
    check(ad.evals.mean() < lock_evals,
          f"adaptive mean evaluations {ad.evals.mean():.1f} < lockstep {lock_evals}")
    check(np.array_equal(direct.evals, akw["N"] * direct.steps.sum(axis=1)),
          "GGM adaptive: evals == N x the lane steps")

    # calibrate_ggm from a spec 20 % off the truth
    truth_p = [dict(G=1.0, J=5.0), dict(G=0.2, J=1.0)]
    off = [dict(G=1.2, J=4.0), dict(G=0.16, J=1.2)]
    spec = [[("twoLocusRouse", dict(p), 0.1, 0)] for p in off]
    fit._run_adam.graphed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cal = fit.calibrate_ggm(spec, batch, rounds=1, engine="batch",
                            sample_kwargs=GGM_KW, device=DEVICE,
                            generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    cal_wall = time.perf_counter() - t0
    graphed = fit._run_adam.graphed
    steps = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit.fit_ggm(spec, batch, cal.profiles, steps=steps, device=DEVICE)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps

    def dist(ps):
        return sum(abs(np.log(p[k] / t[k])) for p, t in zip(ps, truth_p) for k in t)

    trace = cal.fits[0].nll_trace
    print(f"ggm calibrate_ggm(rounds=1, engine='batch') on config 6: wall "
          f"{cal_wall:.3f} s, fitted {cal.parameters}, distance to the truth "
          f"(sum |log ratio|) {dist(off):.4f} -> {dist(cal.parameters):.4f}, nll "
          f"{trace[0]:.5f} -> {trace[-1]:.5f}; a {steps}-step fit alone: "
          f"{per_step * 1e3:.3f} ms per Adam step (build and capture "
          f"included), objective as a CUDA graph: {bool(graphed)}", flush=True)
    check(dist(cal.parameters) < dist(off), "fitted G, J moved towards the truth")
    check(trace[-1] < trace[0] and np.isfinite(trace).all(), "nll trace falls")
    check(graphed == 1, "the calibration objective ran as one CUDA graph")
    check(cal.model.device.type == DEVICE, "the calibrated model is on the card")

    ggm_dataset(bt, 7)

    # sample() on one trajectory, saved, loaded and resumed
    small = ggm_model(device=DEVICE, dtype=torch.float32)
    true = np.zeros(20, dtype=int)
    true[8:15] = 1
    traj = small.trajectory_from_loopingprofile(true, rng=np.random.default_rng(5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bt.sample(traj, small, init_runs=5, sampler_kw={"N": 20, "max_fev": 2000},
                    k_max=4, generator=torch.Generator(device=DEVICE).manual_seed(2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    builds = small.table_builds
    with tempfile.TemporaryDirectory() as d:
        save_results(os.path.join(d, "ck.npz"), res)
        loaded = load_results(os.path.join(d, "ck.npz"), small)
    i = next(i for i, s in enumerate(res.samplers) if not s.exhausted)
    for s in (res.samplers[i], loaded.samplers[i]):
        s.steps(2)
    a, b = res.samplers[i].state.to_numpy(), loaded.samplers[i].state.to_numpy()
    print(f"ggm sample(): wall {wall:.3f} s, {len(res.samplers)} samplers, "
          f"best_k {res.best_k()}, evidence {np.round(res.evidence, 3).tolist()}, "
          f"table builds {builds}", flush=True)
    check(len(res.k) >= 2 and np.all(np.isfinite(res.evidence)),
          "GGM sample(): finite evidences")
    check(builds == 1, "one table build for every sampler")
    check(np.array_equal(res.evidence, loaded.evidence)
          and all(np.array_equal(a[f], b[f]) for f in a)
          and res.samplers[i].evidences == loaded.samplers[i].evidences,
          "GGM: a loaded sampler's steps equal the uninterrupted ones bit for bit")

    ran = counters.read()
    print(f"ggm phase: {time.perf_counter() - t_phase:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, Rouse launches "
          f"and plain calls {ran}", flush=True)
    check(all(v == 0 for k, v in ran.items()
              if k in ROUSE_COUNTERS or k.startswith("plain")),
          f"no Rouse kernel or plain version ran in the GGM phase: {ran}")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(bt, work):
    """Config 3 split over the ranks of a torch.distributed world (see the
    module docstring): (a) one rank on NCCL in this process, (b) two CLI
    processes sharing the card over gloo. Returns the launch counters of
    both, summed."""
    import torch.distributed as dist
    from bild_tpu_torch.parallel import (make_mesh, sample_dataset,
                                         sample_dataset_sharded)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1,
                                      device=DEVICE, dtype=torch.float32)
    truths, true_k, batch, trajs = config3_data(model, T=T)
    ids = np.arange(len(trajs))
    kw = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
              scout_steps=4, refine_top=3, marginals=True, chunk_size=64)

    def gen():
        return torch.Generator().manual_seed(7)

    def runs(mesh):
        return (sample_dataset(model, trajs, **kw, mesh=mesh, generator=gen()),
                sample_dataset_sharded(model, trajs, ids, **kw, mesh=mesh,
                                       generator=gen()))

    def same(a, b):
        return (all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("evidence", "evidence_se", "mom_ok"))
                and all(np.array_equal(x, y) for x, y in zip(
                    a.profiles_by_k + a.marginals, b.profiles_by_k + b.marginals)))

    # (a) a one-rank NCCL world against the mesh-free runs
    ref = runs(None)
    mesh = make_mesh(axis_names=("data",), distributed=True,
                     coordinator_address=f"127.0.0.1:{free_port()}",
                     num_processes=1, process_id=0,
                     timeout=datetime.timedelta(seconds=120))
    try:
        one = torch.ones(1, device=mesh.device)
        dist.all_reduce(one)
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = runs(mesh)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        ran = counters.read()
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    bits_a = [same(x, y) for x, y in zip(got, ref)]
    print(f"mesh one-rank {backend} world: sample_dataset and "
          f"sample_dataset_sharded {wall_a:.3f} s together, equal to the "
          f"mesh-free runs bit for bit: {bits_a}, launches {ran}", flush=True)
    check(backend == "nccl" and float(one) == 1.0, "a one-rank NCCL world")
    check(all(bits_a), "one-rank mesh runs equal the mesh-free runs")
    kernel = launched_kernel(bt.config.rouse_kernel(), "mesh")
    check(ran[kernel] > 0, f"{kernel} launched")
    check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
          "no plain version ran on the CUDA path")
    check(np.all(np.isfinite(got[1].evidence)) and np.array_equal(got[1].ids, ids),
          "sharded evidence finite, ids in order")

    # (b) two processes on disjoint shards (ids interleaved), and one
    # process on both
    shards = [os.path.join(work, f"shard{r}.csv") for r in range(2)]
    for r, path in enumerate(shards):
        write_two_locus_csv(path, batch, range(r, batch.B, 2))
    both = os.path.join(work, "both.csv")
    write_two_locus_csv(both, batch, range(batch.B))
    common = ["--two-locus", "--k-max", "4", "--steps-per-k", "12",
              "--proposals", "128", "--scout-steps", "4", "--refine-top", "3",
              "--chunk-size", "64", "--marginals", "--seed", "7", "--quiet",
              "--process-local"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    port = free_port()
    ranks_env = [dict(env, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port)) for r in range(2)]
    outs = [os.path.join(work, f"mesh{i}") for i in range(3)]
    procs = []

    def launch(i, args, job_env):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CLI_RUNNER, outs[i] + ".json", *args,
             *common, "--out", outs[i] + ".npz"], env=job_env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        return time.perf_counter(), procs[-1]

    def finish(job, what):
        t0, p = job
        _, err = p.communicate(timeout=300)
        check(p.returncode == 0, f"{what} exited {p.returncode}: {err[-2000:]}")
        return time.perf_counter() - t0

    try:
        jobs = [launch(r, [shards[r], "--mesh", "--checkpoint-dir",
                           os.path.join(work, "mesh_ck")], ranks_env[r])
                for r in range(2)]
        walls = [finish(j, f"mesh CLI rank {r}") for r, j in enumerate(jobs)]
        walls.append(finish(launch(2, [both], env), "one-process CLI"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    counts, results = [], []
    for out in outs:
        with open(out + ".json") as f:
            counts.append(json.load(f))
        results.append(dict(np.load(out + ".npz", allow_pickle=True)))

    def equal(a, b):
        return set(a) == set(b) and all(
            all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
            if a[k].dtype == object else np.array_equal(a[k], b[k]) for k in a)

    bits_b = equal(results[0], results[1]) and equal(results[0], results[2])
    acc = float(np.mean(np.concatenate(list(results[0]["best_profiles"]))
                        == truths.ravel()))
    sw = float(np.mean(results[0]["best_k"] == true_k))
    files = len(os.listdir(os.path.join(work, "mesh_ck")))
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s, two gloo ranks "
          f"on one card: walls {walls[0]:.3f} s and {walls[1]:.3f} s (process "
          f"start to exit), one process {walls[2]:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB here, "
          f"{counts[0]['peak_device_gib']:.2f} and {counts[1]['peak_device_gib']:.2f} "
          f"GiB in the ranks; bits_equal {bits_b}; frame accuracy {acc:.4f}, "
          f"switch-count accuracy {sw:.4f}; checkpoint files {files}, written "
          f"by rank 0: {counts[0]['checkpoint_writes']}, rank 1: "
          f"{counts[1]['checkpoint_writes']}; counters {counts}", flush=True)
    check(bits_b, "both ranks' --out files are identical and equal the "
          "one-process run")
    check(acc >= DATASET_FRAME_ACCURACY and sw >= DATASET_SWITCH_ACCURACY,
          f"two-rank accuracy {acc:.4f} / {sw:.4f}")
    check(counts[0]["checkpoint_writes"] == files > 0
          and counts[1]["checkpoint_writes"] == 0,
          "only rank 0 wrote checkpoint files")
    for c in counts:
        check(c[kernel] > 0 and c["plain_sym"] == c["plain_dense"]
              == c["plain_torch"] == 0, "every process launched the kernel")
    return {k: ran[k] + sum(c[k] for c in counts)
            for k in ("kalman_sym", "kalman_dense")}


# tools/assoc_crossover.py's grid, on one card: (T, P) cells, bild_tpu's
# model (N=20, d=3, two states), data from numpy normal draws
ASSOC_GRID = ((1024, 1), (1024, 8), (1024, 64), (4096, 1), (4096, 8),
              (16384, 1), (16384, 8))
# float64 against the dense kernel's float64 build: (T, missing frames)
ASSOC_CHECKS = ((1024, 30), (8192, 200))
RTOL_ASSOC_DENSE = 1e-8
# the time meshes: T, profiles; a one-rank NCCL world against mesh=None,
# two gloo processes on the card against one process
ASSOC_MESH_T, ASSOC_MESH_P = 8192, 2
RTOL_ASSOC_ONE_RANK = 1e-12
RTOL_ASSOC_TWO_RANKS = 1e-10

# one rank of `assoc_phase`'s two-process time mesh: joins a two-rank
# world (gloo: both ranks share the card), evaluates `assoc_case`'s
# profiles over the mesh and saves the result to argv[3]
ASSOC_RUNNER = """
import datetime, sys
import numpy as np
import torch
import torch.distributed as dist
import bild_tpu_torch as bt
import chip_smoke
port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
mesh = bt.parallel.make_mesh((2,), axis_names=("time",), distributed=True,
                             coordinator_address=f"127.0.0.1:{port}",
                             num_processes=2, process_id=rank,
                             timeout=datetime.timedelta(seconds=120))
model, traj, prof = chip_smoke.assoc_case(
    bt, chip_smoke.ASSOC_MESH_T, 200, chip_smoke.ASSOC_MESH_P, torch.float64)
got = model.logL_batch_assoc(prof, traj, mesh=mesh)
np.savez(out, got=got.cpu().numpy(), backend=mesh.backend,
         device=got.device.type, shape=str(mesh.shape))
dist.destroy_process_group()
"""


def assoc_case(bt, T, missing, P, dtype, seed=7):
    """bild_tpu's crossover model on the card, a ``(T, 3)`` trajectory of
    numpy normal draws with ``missing`` frames missing (frame 0 among them
    when ``missing`` > 0), and ``(P, T)`` random two-state profiles."""
    model = bt.models.MultiStateRouse(N, D, KSPRING, d=DIM,
                                      localization_error=0.1, device=DEVICE,
                                      dtype=dtype)
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(T, DIM))
    if missing:
        data[0] = np.nan
        data[rng.choice(np.arange(1, T), size=missing - 1, replace=False)] = np.nan
    traj = bt.Trajectory.create(data, device=DEVICE, dtype=dtype)
    return model, traj, rng.integers(0, 2, size=(P, T)).astype(np.int32)


def assoc_phase(bt, work):
    """The temporal-parallel filter on the card: the crossover grid
    `ASSOC_GRID` (assoc, sym, dense and the plain recursion in float32 on
    the same profiles: ms per call with CUDA events, three calls after a
    warm-up, the plain recursion's one call; and the filter's peak device
    memory above its inputs), float64 against the dense kernel's float64 build at
    `ASSOC_CHECKS`, a one-rank NCCL ``time`` mesh against ``mesh=None``, and
    two gloo processes sharing the card (`ASSOC_RUNNER`) against one
    process. Returns the kernels' launches in the evaluations (not the
    timing loops)."""
    import torch.distributed as dist
    from bild_tpu_torch.experimental.assoc_kalman import msrouse_logL_assoc_batch
    from bild_tpu_torch.ops.kalman import msrouse_logL_batch
    from bild_tpu_torch.ops.kalman_dense import msrouse_logL_dense
    from bild_tpu_torch.ops.kalman_sym import msrouse_logL_sym
    from bild_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    launches = {}

    def counted(fns):
        """Each function once, its kernels' launches summed into
        ``launches``; the results on the host."""
        counters.reset()
        out = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        for k, v in counters.read().items():
            launches[k] = launches.get(k, 0) + v
        return {k: v.cpu().numpy().astype(float) for k, v in out.items()}

    def args(model, traj, prof):
        s2, Cind = model._noise_arrays(traj)
        return (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                s2, Cind, torch.as_tensor(prof, device=DEVICE), traj.data,
                traj.valid)

    for T, P in ASSOC_GRID:
        model, traj, prof = assoc_case(bt, T, 0, P, torch.float32)
        a = args(model, traj, prof)
        ops = model.sym_operators()
        fns = {"assoc": lambda: msrouse_logL_assoc_batch(*a),
               "kalman_sym": lambda: msrouse_logL_sym(*a, ops=ops),
               "kalman_dense": lambda: msrouse_logL_dense(*a),
               "plain": lambda: msrouse_logL_batch(*a)}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vals = counted({"assoc": fns["assoc"]})
        peak = torch.cuda.max_memory_allocated() - base
        # the plain recursion (seconds at T=16384) is timed on its one
        # evaluation: a frame loop of thousands of launches needs no warm-up
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def plain():
            start.record()
            out = fns["plain"]()
            stop.record()
            return out

        vals.update(counted({"kalman_sym": fns["kalman_sym"],
                             "kalman_dense": fns["kalman_dense"],
                             "plain": plain}))
        check(all(np.all(np.isfinite(v)) for v in vals.values()),
              f"assoc grid T={T} P={P}: finite")
        ms = {k: time_ms(fns[k], 3) for k in ("assoc", "kalman_sym", "kalman_dense")}
        ms["plain"] = start.elapsed_time(stop)
        print(f"assoc grid T={T:5d} P={P:2d} float32: assoc {ms['assoc']:.3f} ms "
              f"(peak {peak / 2**30:.3f} GiB above the inputs), sym "
              f"{ms['kalman_sym']:.3f} ms, dense {ms['kalman_dense']:.3f} ms, "
              f"plain {ms['plain']:.3f} ms; assoc / dense "
              f"{ms['assoc'] / ms['kalman_dense']:.1f}x; assoc against dense "
              f"max rel {rel_err(vals['assoc'], vals['kalman_dense']):.2e}",
              flush=True)

    for T, missing in ASSOC_CHECKS:
        model, traj, prof = assoc_case(bt, T, missing, 8, torch.float64)
        a = args(model, traj, prof)
        vals = counted({"assoc": lambda: msrouse_logL_assoc_batch(*a),
                        "dense": lambda: msrouse_logL_dense(*a)})
        err = rel_err(vals["assoc"], vals["dense"])
        print(f"assoc float64 T={T} ({missing} frames missing, frame 0 among "
              f"them), P=8: max rel {err:.2e} against the dense kernel's "
              f"float64 build", flush=True)
        check(err <= RTOL_ASSOC_DENSE,
              f"assoc float64 T={T} within {RTOL_ASSOC_DENSE} of dense")

    # a one-rank NCCL time mesh, and two gloo processes on the card
    model, traj, prof = assoc_case(bt, ASSOC_MESH_T, 200, ASSOC_MESH_P,
                                   torch.float64)
    one = model.logL_batch_assoc(prof, traj).cpu().numpy()
    mesh = make_mesh((1,), axis_names=("time",), distributed=True,
                     coordinator_address=f"127.0.0.1:{free_port()}",
                     num_processes=1, process_id=0,
                     timeout=datetime.timedelta(seconds=120))
    try:
        unit = torch.ones(1, device=mesh.device)
        dist.all_reduce(unit)
        got = model.logL_batch_assoc(prof, traj, mesh=mesh)
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    check(got.device.type == "cuda", "logL_batch_assoc returns a CUDA tensor")
    err1 = rel_err(got.cpu().numpy(), one)
    print(f"assoc one-rank {backend} time mesh {mesh.shape}, T={ASSOC_MESH_T}: "
          f"max rel {err1:.2e} against mesh=None", flush=True)
    check(backend == "nccl" and float(unit) == 1.0, "a one-rank NCCL world")
    check(err1 <= RTOL_ASSOC_ONE_RANK,
          f"one-rank time mesh within {RTOL_ASSOC_ONE_RANK} of mesh=None")

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    port = free_port()
    outs = [os.path.join(work, f"assoc{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", ASSOC_RUNNER, str(port),
                               str(r), outs[r]], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            check(p.returncode == 0, f"assoc rank {r} exited {p.returncode}: "
                  f"{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    res = [dict(np.load(o)) for o in outs]
    errs = [rel_err(r["got"], one) for r in res]
    print(f"assoc two ranks on one card: {wall:.3f} s (process start to exit), "
          f"backends {[str(r['backend']) for r in res]}, devices "
          f"{[str(r['device']) for r in res]}, mesh {str(res[0]['shape'])}; max "
          f"rel against one process {errs[0]:.2e} / {errs[1]:.2e}; ranks "
          f"equal: {np.array_equal(res[0]['got'], res[1]['got'])}", flush=True)
    check(all(str(r["backend"]) == "gloo" and str(r["device"]) == "cuda"
              for r in res), "both ranks on the card over gloo")
    check(max(errs) <= RTOL_ASSOC_TWO_RANKS,
          f"two-rank time mesh within {RTOL_ASSOC_TWO_RANKS} of one process")
    print(f"assoc phase: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{launches}", flush=True)
    return launches


def timing_phase(bt, rng):
    """Kernel and plain version at the AMIS step (P=100), in the order
    plain, kernel, kernel, plain, beside the bound computed from the same
    inputs (the bench shape, P=8192, is `bench_phase`'s): the dense
    kernel, the sym kernel's cluster plan (the planner's at this step,
    ``kalman_sym_cluster``) and the same launch forced onto its tile plan
    (``kalman_sym``). Returns ``{(name, P): (ms, plain_ms, bound_ms,
    bound_by)}``."""
    from bild_tpu_torch.ops.kalman_dense import (msrouse_logL_dense,
                                                 msrouse_logL_dense_torch)
    from bild_tpu_torch.ops.kalman_dense import sm_count
    from bild_tpu_torch.ops.kalman_sym import (msrouse_logL_sym,
                                               msrouse_logL_sym_torch, sym_plan)

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
    for P, reps in ((100, 20),):
        prof = torch.as_tensor(make_profiles(rng, P, 2, T), device=DEVICE)
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s,
                model.w, s2, Cind, prof, traj.data, traj.valid)
        check(sym_plan(1, P, 2, N, DIM, 1, 4, sms=sm_count(0)).cluster > 0,
              f"the sym kernel's cluster plan at sample()'s step (P={P})")
        fns = {
            "kalman_sym": (lambda: msrouse_logL_sym(*args, ops=ops, _force="tile"),
                           lambda: msrouse_logL_sym_torch(ops, *args[6:])),
            "kalman_sym_cluster": (lambda: msrouse_logL_sym(*args, ops=ops),
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
            print(f"time {name:18s} P={P:5d}  kernel {ms:9.3f} ms "
                  f"({P / ms * 1e3:12.1f} profiles/s)  plain {plain_ms:9.3f} ms "
                  f"({P / plain_ms * 1e3:12.1f} profiles/s)  bound {bnd:.4f} ms "
                  f"({by}), {bnd / ms:.1%} of bound", flush=True)
    # the P=8192 profiles this phase once drew and timed: drawn still, so
    # that the later phases' draws from ``rng`` keep their bits
    make_profiles(rng, 8192, 2, T)
    return times


def bench_phase(bt):
    """bench_torch.py's measurement, once: at its shape (L=1, P=8192,
    T=100) each kernel of `bench_torch.likelihoods` against its plain
    version (exact tier and dense `RTOL_F32`, 'split_cov' `RTOL_SPLIT`,
    'split' `split_bar`) with the float64 build beside it, then
    `bench_torch.bench_line` (which checks that every kernel launched and
    no plain version ran, then times them beside the bound), printed as
    its JSON line. Returns the line."""
    model, traj, profiles = bench_torch.workload(device=DEVICE)
    got, _ = bench_torch.evaluate(model, traj, profiles)
    plain = {name: p().cpu().numpy().astype(float)
             for name, (_, p) in bench_torch.likelihoods(model, traj, profiles).items()}
    model64 = bench_torch.rouse_model(DEVICE, torch.float64)
    f64, _ = bench_torch.evaluate(model64, traj.to(dtype=torch.float64), profiles)
    for name in got:
        check(np.all(np.isfinite(got[name])), f"bench shape {name}: finite")
        e_plain, e_p64 = rel_err(got[name], plain[name]), rel_err(plain[name], f64[name])
        tier = name[len("kalman_sym_"):] if name.startswith("kalman_sym_") else None
        bar = RTOL_F32 if tier is None else split_bar(tier, e_p64)
        line = (f"bench shape L=1 P={len(profiles)} T={profiles.shape[1]} {name:20s} "
                f"kernel against plain rel {e_plain:.2e} (bar {bar:.2e}); against "
                f"the float64 build: kernel {rel_err(got[name], f64[name]):.2e}, "
                f"plain {e_p64:.2e}")
        print(line, flush=True)
        check(e_plain <= bar, f"{line}: kernel within its bar of the plain version")
    line = bench_torch.bench_line()
    print(json.dumps(line), flush=True)
    check(line["tier"] == bt.config.resolve_matmul("lockstep")
          and math.isfinite(line["value"]) and line["value"] > 0
          and line["vs_baseline"] > 0, "bench line: a finite rate of the default tier")
    return line


def bench_e2e_phase(bt):
    """bench_e2e_torch.py's config 2 (the one config no other phase runs):
    `sample()` on one trajectory and the float32 kernel against the
    float64 oracle on 64 profiles, under the shipped tier; its dict
    printed. Bars: frame accuracy `SLICE_ACCURACY`, kernel parity
    `RTOL_F32` (PERF.md section 2), the kernel launched and no plain
    version. Returns the launch counts of the run."""
    counters.reset()
    r = bench_e2e_torch.run_configs(["2"], bt.config.rouse_matmul(), device=DEVICE)["2"]
    ran = counters.read()
    line = (f"bench_e2e config 2: frame accuracy {r['frame_accuracy']:.4f} (bar "
            f"{SLICE_ACCURACY}), kernel parity against the float64 oracle "
            f"{r['kernel_parity_rel_vs_f64_oracle']:.2e} (bar {RTOL_F32}), "
            f"best k {r['best_k']} (true {r['true_k']}), launches {ran}")
    print(line, flush=True)
    check(r["frame_accuracy"] >= SLICE_ACCURACY, f"{line}: frame accuracy")
    check(r["kernel_parity_rel_vs_f64_oracle"] <= RTOL_F32, f"{line}: kernel parity")
    check(ran["kalman_sym"] > 0 and not any(v for k, v in ran.items()
                                            if k.startswith("plain")),
          f"{line}: the kernel ran, no plain version")
    return ran


def sample_time_split(run):
    """One call of ``run`` (a `sample()`): ``(result, wall s, {"steps": s,
    "samplers": s, "choice": s})``, the wall split into the samplers'
    `steps` calls (the AMIS steps with their one fetch each, so every
    step's device work ends inside them), the samplers' construction (the
    exhaustive enumeration, the lane likelihood) and the rest: the choice
    loop on the host (`ChoiceSampler`, numpy)."""
    from bild_tpu_torch.amis.sampler import FixedkSampler

    spent = {"steps": 0.0, "samplers": 0.0}
    steps, init = FixedkSampler.steps, FixedkSampler.__init__

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    FixedkSampler.steps, FixedkSampler.__init__ = (timed("steps", steps),
                                                   timed("samplers", init))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        FixedkSampler.steps, FixedkSampler.__init__ = steps, init
    spent["choice"] = wall - spent["steps"] - spent["samplers"]
    return res, wall, spent


def slice_phase(bt):
    """`sample()` on the README trajectory under each kernel selector, its
    samplers' steps replaying one CUDA graph (`parallel.graphs`). Reads
    the whole counter registry (`ops.counters`): the selector's kernel,
    csrc/gamma_accept.cu and csrc/cfc_solve.cu launched, no plain version
    ran. Prints the wall of the first call (which captures the graph) and
    of the second (which must capture none and give the same bits), that
    wall split into steps, sampler construction and the choice loop
    (`sample_time_split`), the captures and replays, and, from a traced
    third call, the busy share, the host launch calls per AMIS step (the
    graph's copies among them) and each hand kernel's launches and device
    time. Returns ``(counts summed
    over every selector, {selector: readings})``."""
    from bild_tpu_torch.parallel import graphs

    model, true, traj = readme_case(bt)
    lls = model.logL_batch(np.stack([true, 0 * true, 0 * true + 1]), traj)
    lls = lls.cpu().numpy()
    check(np.argmax(lls) == 0, f"true profile ranks first: {lls}")

    def run():
        return bt.sample(traj, model,
                         generator=torch.Generator(device=DEVICE).manual_seed(7))

    totals, readings = {}, {}
    found = bt.config.rouse_kernel()
    for selector in ("auto", "sym", "dense"):
        bt.config.set_rouse_kernel(selector)
        graphs.clear()
        counters.reset()
        caps, reps = graphs.replay.captures, graphs.replay.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = counters.read()
        caps, reps = graphs.replay.captures - caps, graphs.replay.replays - reps
        caps2 = graphs.replay.captures
        again, again_wall, split = sample_time_split(run)
        caps2 = graphs.replay.captures - caps2
        copies = graphs.replay.copies
        dev_ms, traced_wall, calls, _, kern = graph_profile(run)
        copies = graphs.replay.copies - copies
        best = np.asarray(res.best_profile()[:])
        acc = float(np.mean(best == true))
        post = res.log_marginal_posterior(dE="average")
        steps = sum(s.n_steps_host for s in res.samplers)
        evals = sum(len(s._exhaustive["logLs"]) if s._exhaustive is not None
                    else s.n_steps_host * s.N for s in res.samplers)
        per_kernel = {k: {"launches": n, "device_ms": ms, "us_per_launch":
                          ms * 1e3 / n} for k, (n, ms) in kern.items()}
        readings[selector] = {
            "wall_s": wall, "again_wall_s": again_wall,
            "split_s": split, "captures": caps, "replays": reps,
            "captures_again": caps2, "steps": steps, "evals": evals,
            "device_ms": dev_ms, "traced_wall_s": traced_wall,
            "busy_share": dev_ms / 1e3 / traced_wall,
            "launch_calls_per_step": calls / max(steps, 1),
            "copies_per_step": copies / max(steps, 1),
            "kernels": per_kernel, "launches": ran, "frame_accuracy": acc}
        print(f"slice selector={selector}: wall {wall:.3f} s (captures "
              f"{caps}, replays {reps}); again {again_wall:.3f} s (captures "
              f"{caps2}; steps {split['steps']:.3f} s, sampler construction "
              f"{split['samplers']:.3f} s, choice loop {split['choice']:.3f} s); "
              f"traced: busy {dev_ms / 1e3 / traced_wall:.4f} ({dev_ms:.1f} ms "
              f"of {traced_wall:.3f} s), {calls / max(steps, 1):.1f} host launch "
              f"calls per AMIS step (of them {copies / max(steps, 1):.1f} copies "
              f"into and out of the graph's buffers); kernels "
              + ", ".join(f"{k} {v['launches']} x {v['us_per_launch']:.1f} us"
                          for k, v in per_kernel.items())
              + f"; AMIS steps {steps}, logL evaluations {evals}, best_k "
              f"{res.best_k()}, frame accuracy {acc:.3f}, evidence "
              f"{np.round(res.evidence, 3).tolist()}, launches {ran}", flush=True)
        check(acc >= SLICE_ACCURACY, f"MAP profile >= {SLICE_ACCURACY} frame-correct")
        check(post.shape == (2, T) and np.all(np.isfinite(np.exp(post))),
              "marginal posterior finite, (2, T)")
        check(np.all(np.isfinite(res.evidence)), "finite evidences")
        check(same_sample(res, again), "a second sample() from the same seed "
              "gives the same bits")
        kernel = launched_kernel(selector, "sample()")
        check(ran[kernel] > 0, f"{selector}: {kernel} launched")
        # each AMIS step launches the sym kernel once at (L=1, P=N=100): its
        # cluster plan ('sym' and 'auto'); the samplers' exhaustive
        # enumerations add launches of either plan, or of the dense kernel
        # under 'auto' where they fill the SMs (k=1 at T=100: 198 profiles)
        check(ran["kalman_sym_cluster"] >= steps if selector in ("sym", "auto")
              else ran["kalman_sym_cluster"] == 0,
              f"selector {selector}: {ran['kalman_sym_cluster']} cluster launches of "
              f"{ran['kalman_sym']} sym launches for {steps} AMIS steps")
        check(ran["gamma_accept"] > 0 and ran["cfc_solve"] > 0,
              "the gamma and CFC kernels launched")
        check(all(ran[k] == 0 for k in ran if k.startswith("plain")),
              f"no plain version ran on the CUDA path: {ran}")
        check(caps == 1 and caps2 == 0 and reps == steps - 1,
              f"sample() replays one graph: {caps} captures, {reps} replays of "
              f"{steps} steps, {caps2} captures again")
        totals = {k: totals.get(k, 0) + v for k, v in ran.items()}
    bt.config.set_rouse_kernel(found)
    return totals, readings


def build_all(parent_tree):
    """Build every kernel of csrc/ (and the split kernel's probe copy), one
    nvcc per source, all at once; beside them ``nvcc -Xptxas -v`` of the
    step and likelihood kernels (`ptxas_report`) and the same kernels of
    the parent checkout at ``parent_tree`` where it has them
    (`build_parent`). Prints the seconds each build (or the load of a
    library built before) took; returns ``(parent, ptxas)`` as
    `step_kernel_phase` and `parent_kernel_phase` take them."""
    from bild_tpu_torch.ops import _build

    def timed_load(build):
        t0 = time.perf_counter()
        _build.load(*build)
        return time.perf_counter() - t0

    builds = [(name, ()) for name in ("kalman_sym", "kalman_sym_split",
                                      "kalman_dense", "cfc_solve",
                                      "gamma_accept")]
    builds.append(("kalman_sym_split", (PROBE_DEFINE,)))   # split_phase's probe
    timed_names = ("cfc_solve", "gamma_accept", "kalman_sym", "kalman_dense")
    parent_names = [name for name in timed_names
                    if (Path(parent_tree) / "bild_tpu_torch" / "csrc"
                        / f"{name}.cu").exists()]
    with ThreadPoolExecutor(len(builds) + 2 * len(timed_names)) as pool:
        loads = pool.map(timed_load, builds)
        reports = {name: pool.submit(ptxas_report, name) for name in timed_names}
        parents = {name: pool.submit(build_parent, parent_tree, name)
                   for name in parent_names}
        seconds = list(loads)
        ptxas = {name: f.result() for name, f in reports.items()}
        parent = {name: f.result() for name, f in parents.items()}
    for (name, defines), took in zip(builds, seconds):
        key = name + "".join(f"-{x.lower()}" for x in defines)
        print(f"build {key}: {took:.2f} s", flush=True)
    print(f"parent kernels: {sorted(parent) or 'none'} (from "
          f"{parent_tree})", flush=True)
    return parent, ptxas


def main():
    import argparse

    parser = argparse.ArgumentParser(description="Drive bild_tpu_torch on one "
                                                 "NVIDIA GPU, end to end.")
    parser.add_argument("--parent", default=str(PARENT_TREE),
                        help="a checkout of the parent commit whose "
                             "kernels the step kernel phase times beside "
                             "this checkout's, where it exists (default: "
                             "_chip/parent)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    import bild_tpu_torch as bt

    print(card(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    bt.config.exact_fp32()

    names = ("kalman_sym", "kalman_dense")
    parent, ptxas = build_all(args.parent)

    rng = np.random.default_rng(20261016)
    max_abs = kernel_phase(bt, rng)
    times = timing_phase(bt, rng)
    bench = bench_phase(bt)
    launches, slice_readings = slice_phase(bt)
    e2e_launches = bench_e2e_phase(bt)
    lane_kernel_phase(bt, rng, max_abs)
    cluster = cluster_phase(bt)
    lock_times, drift = lockstep_phase(bt, rng, max_abs)
    parent_times = parent_kernel_phase(bt, parent, ptxas)
    ladder = ladder_phase(bt)
    split = split_phase(bt, rng)
    tier_launches = tiers_phase(bt, ladder)
    step_kernels = step_kernel_phase(bt, parent, ptxas)
    ds_launches = dataset_phase(bt)
    ad_launches = adaptive_phase(bt)
    c4_launches = config4_phase(bt, drift)
    graph = graph_phase(bt)
    c5_launches = config5p_phase(bt)
    with tempfile.TemporaryDirectory() as work:
        cli_counts = cli_phase(bt, work)
    ck_launches = checkpoint_phase(bt)
    ex_counts = examples_phase(bt)
    range_phase(bt, rng)
    ggm_phase(bt, rng)
    with tempfile.TemporaryDirectory() as work:
        mesh_launches = mesh_phase(bt, work)
    with tempfile.TemporaryDirectory() as work:
        assoc_launches = assoc_phase(bt, work)

    replaces = {"kalman_sym": "bild_tpu/ops/kalman_sym.py:189",
                "kalman_dense": "bild_tpu/ops/kalman_pallas.py:50"}
    # "ms", "plain_ms" and "bound_ms" at the AMIS step of sample() (one
    # trajectory, P=100); "lockstep_*" at config 3's lockstep launch (L=640,
    # P=128); "adaptive_*" at the adaptive round's (L=128, P=128);
    # "config4_*" at config 4's scout launch (L=112, P=128, T=1000, three
    # states); "config5_*" at config 5's (L=5,120, P=128); "bench_*" at
    # bench_torch.py's (L=1, P=8192). No single
    # PyTorch call computes the recursion: library_ms is null. "launches"
    # sums the main-path runs: sample(), bench_e2e_torch.py's config 2,
    # the lockstep and adaptive dataset
    # runs, config 4 under every selector, config 5p, the CLI runs, the
    # checkpoint phase, the examples, the mesh phase (its own process
    # and its three CLI processes), and the tiers and assoc phases (the
    # kernels beside the square-root and temporal-parallel filters, one
    # evaluation per shape). The calibration's M-step runs the plain
    # recursion under autograd by design: its calls stand apart, under
    # "calibration_plain_calls".
    main_path = [launches, e2e_launches, cli_counts, ck_launches, mesh_launches,
                 c5_launches, ex_counts, tier_launches, assoc_launches,
                 *ds_launches.values(), *ad_launches.values(),
                 *c4_launches.values()]
    shapes = {"lockstep": "one chunk of 128", "adaptive": "adaptive round",
              "config4": "config 4 scout", "config5": "config 5 scout"}
    kernels = []
    for name in names:
        row = {
            "name": name, "route": "cuda",
            "source": f"bild_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": sum(r[name] - (r.get("kalman_sym_split", 0)
                                       + r.get("kalman_sym_cluster", 0)
                                       if name == "kalman_sym" else 0)
                            for r in main_path),
            "max_abs_err": max_abs[name],
            "ms": times[(name, 100)][0],
            "plain_ms": times[(name, 100)][1],
            "bound_ms": times[(name, 100)][2],
            "bound_by": times[(name, 100)][3],
            "library_ms": None,
        }
        for key, label in shapes.items():
            ms, plain_ms, bnd = lock_times[(name, label)]
            row.update({f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
                        f"{key}_bound_ms": bnd})
        b = bench["kernels"][name]
        row.update(bench_ms=b["ms"], bench_plain_ms=b["plain_ms"],
                   bench_bound_ms=b["bound_ms"])
        # the parent commit's kernel (a float32 covariance) and this one
        # at PERF.md's table shapes, in turns in one call
        row["parent"] = {label: {"ms": ms, "parent_ms": parent_ms, "bound_ms": bnd}
                         for (k, label), (ms, parent_ms, bnd) in parent_times.items()
                         if k == name}
        row["ptxas"] = {k: v for k, v in ptxas_rows(ptxas[name]).items()
                        if "cluster" not in k}
        kernels.append(row)
    # The exact tier's cluster plan, a kernel of its own in
    # csrc/kalman_sym.cu: its main path is sample()'s step (L=1, P=100),
    # where "ms", "plain_ms" and "bound_ms" are taken (timing phase, the
    # same inputs as the kalman_sym row's, which is that launch forced onto
    # the tile plan); "launches" the main-path runs' cluster launches;
    # "max_abs_err" the cluster phase's float32 launches against the plain
    # version; "clusters_of_16_ms" and "tile_plan_ms" the cluster phase's
    # times in turns; "parent" the parent commit's kernel at that step, in
    # turns.
    sym_row = kernels[0]
    step = parent_times.get(("kalman_sym", "sample() step"))
    kernels.insert(1, {
        "name": "kalman_sym_cluster", "route": "cuda",
        "source": "bild_tpu_torch/csrc/kalman_sym.cu",
        "replaces": "bild_tpu/ops/kalman_sym.py:189 (exact tier, single-trajectory launches)",
        "launches": sum(r.get("kalman_sym_cluster", 0) for r in main_path),
        "max_abs_err": cluster["max_abs"],
        "ms": times[("kalman_sym_cluster", 100)][0],
        "plain_ms": times[("kalman_sym_cluster", 100)][1],
        "bound_ms": times[("kalman_sym_cluster", 100)][2],
        "bound_by": times[("kalman_sym_cluster", 100)][3],
        "library_ms": None,
        "clusters_of_16_ms": cluster["ms_16"], "tile_plan_ms": cluster["tile_ms"],
        "cluster_slots": cluster["slots"],
        "parent": ({} if step is None else {"sample() step": dict(zip(
            ("ms", "parent_ms", "bound_ms"), step))}),
        "ptxas": {k: v for k, v in ptxas_rows(ptxas["kalman_sym"]).items() if "cluster" in k},
    })
    check(sym_row["name"] == "kalman_sym", "the sym row leads")
    # no main-path launch takes the dense plan's float32 covariance
    cov32 = sum(r.get("kalman_dense_cov32", 0) for r in main_path)
    check(cov32 == 0, f"{cov32} main-path dense launches kept a float32 covariance")
    kernels[-1]["cov32_launches"] = cov32
    # the split tiers of the packed kernel: a kernel of its own
    # (csrc/kalman_sym_split.cu). Its main path is the
    # lockstep dataset run under 'auto' (the split phase's config 3 runs,
    # and every other lockstep run if 'auto' is the default):
    # "ms", "plain_ms" and "bound_ms" are the 'split' tier's at config 3's
    # lockstep launch (L=640, P=128), "split_cov_*" the other tier's there,
    # "sample_*" both at sample()'s step (L=1, P=100), "config5_*" at
    # config 5's scout (L=5,120). "launches" counts the split launches of
    # the 'auto' run; the kalman_sym row counts the exact tier's.
    st = split["times"]
    kernels.insert(1, {
        "name": "kalman_sym_split", "route": "cuda",
        "source": "bild_tpu_torch/csrc/kalman_sym_split.cu",
        "replaces": "bild_tpu/ops/kalman_sym.py:189 (split_bf16)",
        "launches": split["launches"] + sum(r.get("kalman_sym_split", 0)
                                            for r in main_path),
        "max_abs_err": split["max_abs"],
        "ms": st[("split", 640)][0],
        "plain_ms": st[("split", 640)][1],
        "bound_ms": st[("split", 640)][2],
        "bound_by": st[("split", 640)][3],
        "library_ms": None,
        "split_cov_ms": st[("split_cov", 640)][0],
        "split_cov_plain_ms": st[("split_cov", 640)][1],
        "exact_ms": st[("exact", 640)][0],
        "sample_ms": st[("split", 1)][0], "sample_plain_ms": st[("split", 1)][1],
        "sample_bound_ms": st[("split", 1)][2],
        "sample_split_cov_ms": st[("split_cov", 1)][0],
        "config5_ms": st[("split", 5120)][0],
        "config5_split_cov_ms": st[("split_cov", 5120)][0],
        "config5_bound_ms": st[("split", 5120)][2],
        "bench_ms": bench["kernels"]["kalman_sym_split"]["ms"],
        "bench_plain_ms": bench["kernels"]["kalman_sym_split"]["plain_ms"],
        "bench_bound_ms": bench["kernels"]["kalman_sym_split"]["bound_ms"],
        "bench_split_cov_ms": bench["kernels"]["kalman_sym_split_cov"]["ms"],
        "default_tier": split["default"],
    })
    # The step's kernels, counterparts of device loops of XLA and not of
    # Pallas kernels: the CFC fixed-point solve and the gamma sampler's
    # rejection rounds. "ms" (device time: launches replayed in a CUDA
    # graph), "parent_ms" (the parent commit's kernel on the same inputs,
    # in turns; null without a parent checkout), "host_ms" (back-to-back
    # wrapper calls), "plain_ms" and "bound_ms" at config 3's lockstep scout
    # call (L=640) that iterates or draws most, the bound from the
    # iterations or rounds those inputs take; "sample_*" at sample()'s
    # call, "config4_*" (CFC) at config 4's three-state call whose longest
    # row iterates most, "degenerate_*" (gamma) at shapes 1e5-1e10 in
    # float32; "most" the longest row's iterations or an entry's rounds;
    # "max_abs_err" over every call of the step kernel phase's runs;
    # "launches" over the graph phase's graphed runs and the slice phase's
    # sample() (the main path: the dataset runners and sample() replaying
    # their step), of which "sample_launches" the slice phase's;
    # "sample_device_us" the device time per launch in the traced README
    # sample() ('sym'). No PyTorch call computes the CFC solve: its
    # library_ms is null; the gamma row's is torch._standard_gamma's
    # device time at each timed shape (time only).
    for name, replaces in (
            ("cfc_solve", "bild_tpu/amis/cfc.py:166 (lax.while_loop, not a "
                          "Pallas kernel)"),
            ("gamma_accept", "bild_tpu/amis/dirichlet.py:27 (jax.random.gamma's "
                             "rejection loop, not a Pallas kernel)")):
        row = {"name": name, "route": "cuda",
               "source": f"bild_tpu_torch/csrc/{name}.cu", "replaces": replaces,
               "launches": graph["launches"][name] + launches[name],
               "library_ms": None, "sample_launches": launches[name],
               "sample_device_us": slice_readings["sym"]["kernels"].get(
                   f"{name}_kernel", {}).get("us_per_launch")}
        row.update(step_kernels[name])
        kernels.append(row)
    for row in kernels:
        if row["name"] in (*names, "kalman_sym_cluster"):  # the likelihood kernels in sample()
            sel = row["name"].split("_")[1]   # the selector: sym or dense
            row["sample_device_us"] = slice_readings[sel]["kernels"].get(
                f"{row['name']}_kernel", {}).get("us_per_launch")
    print(json.dumps({"kernels": kernels,
                      "calibration_plain_calls": (cli_counts["calibration_plain"]
                                                  + ex_counts["calibration_plain"]),
                      "slice_phase": slice_readings,
                      "graph_phase": graph["runs"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
