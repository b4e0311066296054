#!/usr/bin/env python3
"""
End-to-end benchmarks of bild_tpu_torch on one NVIDIA GPU: the counterpart
of ``bench_e2e.py`` (which runs bild_tpu), config for config.

    python bench_e2e_torch.py [--configs 2,3,4,6,7] [--out PERF_torch.json]
                              [--matmul {auto,exact,split,split_cov}]

Each config runs a full inference workload on the card through the port's
public entry points and records wall-clock, throughput and accuracy
against the generating truth under bench_e2e.py's keys. Results are written
as JSON (one dict per config) to ``--out`` and printed.

Configs (sizes, truth seeds and sampler arguments as bench_e2e.py's):
  2  `bild_tpu_torch.sample` on one trajectory (T=100, 2-state Rouse), plus
     the float32 kernel against the float64 NumPy oracle on 64 profiles
  3  128 trajectories of T=100 through `parallel.sample_batch` (lockstep)
  4  3-state model, T=1000, 16 trajectories, lockstep
  5  10,240 trajectories in chunks of 1,024 (pass ``--configs 5``)
  5p config 5 + `postproc.optimize_boundary_batch` and the evidence-averaged
     marginal credibility of the climbed profiles
  6  `models.GenericGaussianModel`, 64 trajectories of T=100; the warm wall
     includes the table build (``clear_memo()`` before each run)
  7  the same model with ``T_band=128``, 16 trajectories of T=1000

Differences from bench_e2e.py:
- Random draws: a JAX key becomes a `torch.Generator`. The truths come from
  the same ``np.random.default_rng(c)`` draws as there, bit for bit. The
  Rouse trajectories come from a generator on the model's device seeded 42
  (config 2), 3 and 4 (configs 3 and 4, as chip_smoke.py's runs of them;
  bench_e2e.py draws both from key 0) and 100 + c per chunk (config 5);
  the GGM trajectories from the config's numpy Generator, as there. Each
  sampler's generator is seeded as bench_e2e.py's key: 7, 3, 4, 200 + c,
  6, 7. No torch draw equals a jax.random one, so trajectories, walls and
  accuracies are the port's own.
- ``--matmul`` defaults to the port's shipped tier, ``'exact'`` (bild_tpu
  ships ``'auto'``). So the unsuffixed result keys ("3") belong to
  ``'exact'``, and any other tier suffixes them ("3_auto"), as
  bench_e2e.py suffixes every tier but its default.
- Every dict also carries ``device`` (the card's name and power limit),
  ``kernel`` (`config.rouse_kernel()`, the Rouse likelihood's selector),
  ``matmul`` and ``matmul_tier`` (what the config's likelihood calls
  resolve to). ``kernel`` and ``matmul_tier`` are None for the GGM
  configs, which run no Rouse likelihood. Walls are not rounded.
- No CPU fallback: without a CUDA device ``main()`` exits 1 before any
  config runs. The config functions take ``device=`` and smaller sizes
  for the CPU tests.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.ops.oracle import msrouse_logL_numpy
from bild_tpu_torch.parallel import sample_batch, stack_trajectories
from bild_tpu_torch.postproc import optimize_boundary_batch
from bench_torch import card, rouse_model

DEVICE = bt.config.DEFAULT_DEVICE
LOCKSTEP_KW = dict(k_max=4, steps_per_k=12, N=128, informed_init=True,
                   scout_steps=4, refine_top=3)
GGM_KW = dict(k_max=4, steps_per_k=12, N=128, scout_steps=4, refine_top=3)


def truth_profiles(rng, B, T, n_states, k_max=4):
    """Random piecewise-constant truth profiles with 0..k_max switches
    (bench_e2e.py's ``_truth_profiles``, the same draws)."""
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


def switch_counts(truths):
    return np.sum(truths[:, 1:] != truths[:, :-1], axis=1)


def _accuracy(best_profiles, truths):
    return float(np.mean(np.asarray(best_profiles) == np.asarray(truths)))


def _switch_accuracy(best_k, truths):
    return float(np.mean(np.asarray(best_k) == switch_counts(truths)))


THREE_STATES = (None, (0, -1), (0, 10))


def config3_data(model, B=128, T=100):
    """Config 3's data: ``(truths (B, T), true switch counts, batch,
    trajectories)``, the trajectories made by the port's batched generator
    on the model's device (seeded 3)."""
    truths = truth_profiles(np.random.default_rng(3), B, T, 2)
    batch = model.trajectories_from_loopingprofiles(
        truths, generator=torch.Generator(device=model.device).manual_seed(3))
    trajs = [bt.Trajectory(data=batch.data[i], valid=batch.valid[i],
                           localization_error=np.full(model.d, 0.1))
             for i in range(B)]
    return truths, switch_counts(truths), batch, trajs


def config4_data(model, B=16, T=1000):
    """Config 4's data: ``(truths (B, T), true switch counts, batch)`` of
    three-state truths, made by the port's batched generator on the
    device of the three-state ``model`` (seeded 4)."""
    truths = truth_profiles(np.random.default_rng(4), B, T, 3)
    batch = model.trajectories_from_loopingprofiles(
        truths, generator=torch.Generator(device=model.device).manual_seed(4))
    return truths, switch_counts(truths), batch


def ggm_model(T_band=None, device=DEVICE, dtype=torch.float32):
    """The two-state two-locus-Rouse GGM of configs 6 and 7."""
    GGM = bt.models.GenericGaussianModel
    return GGM([[(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
                [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)]],
               T_band=T_band, device=device, dtype=dtype)


def ggm_data(number, B, T, T_band=None, device=DEVICE, dtype=torch.float32):
    """Config 6's or 7's data: ``(model, truths, true switch counts,
    trajectories, batch)``; truths and trajectories from one numpy
    Generator seeded with the config's number, in that order."""
    rng = np.random.default_rng(number)
    model = ggm_model(T_band=T_band, device=device, dtype=dtype)
    truths = truth_profiles(rng, B, T, 2)
    trajs = [model.trajectory_from_loopingprofile(t, rng=rng) for t in truths]
    return model, truths, switch_counts(truths), trajs, stack_trajectories(trajs)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _warm(run, device):
    """``(result, seconds)`` of the second of two calls of ``run`` (the
    first warms up)."""
    run()
    _sync(device)
    t0 = time.perf_counter()
    res = run()
    _sync(device)
    return res, time.perf_counter() - t0


def _tags(context, T):
    """The Rouse selector and the matmul tier a config's likelihood
    calls resolve to (None, None without a Rouse likelihood)."""
    if context is None:
        return {"kernel": None, "matmul_tier": None}
    return {"kernel": bt.config.rouse_kernel(),
            "matmul_tier": bt.config.resolve_matmul(context, T=T)}


def config2(device=DEVICE, dtype=torch.float32, n_parity=64, **sample_kw):
    """`sample()` on one trajectory, plus the kernel against the float64
    oracle on ``n_parity`` profiles."""
    rng = np.random.default_rng(2)
    model = rouse_model(device, dtype)
    truth = np.zeros(100, dtype=int)
    truth[30:60] = 1
    truth[75:90] = 1
    traj = model.trajectory_from_loopingprofile(
        truth, generator=torch.Generator(device=model.device).manual_seed(42))

    profiles = rng.integers(0, 2, size=(n_parity, 100))
    dev = model.logL_batch(profiles, traj).cpu().numpy().astype(float)
    h = model.host
    oracle = np.array([msrouse_logL_numpy(h["Bs"], h["Gs"], h["Sigs"], h["M0s"],
                                          h["C0s"], h["w"], model._get_noise(traj),
                                          p, traj[:])
                       for p in profiles])
    parity = float(np.max(np.abs((dev - oracle) / oracle)))

    def run():
        return bt.sample(traj, model, **sample_kw,
                         generator=torch.Generator(device=model.device).manual_seed(7))

    res, dt = _warm(run, device)
    best = np.asarray(res.best_profile()[:])
    return {
        "config": 2,
        "wall_s_warm": dt,
        "n_samplers": len(res.k),
        "best_k": int(res.best_k()),
        "true_k": int(np.sum(truth[1:] != truth[:-1])),
        "frame_accuracy": _accuracy(best[None], truth[None]),
        "kernel_parity_rel_vs_f64_oracle": parity,
        **_tags("single", 100),
    }


def _lockstep(model, batch, seed, kw, device):
    return _warm(lambda: sample_batch(model, batch, **kw,
                                      generator=torch.Generator().manual_seed(seed)),
                 device)


def config3(device=DEVICE, dtype=torch.float32, B=128, T=100, **kw):
    """128-trajectory joint lockstep inference (T=100, 3-d, 2-state)."""
    model = rouse_model(device, dtype)
    truths, _, batch, _ = config3_data(model, B, T)
    res, dt = _lockstep(model, batch, 3, {**LOCKSTEP_KW, **kw}, device)
    return {
        "config": 3,
        "B": B,
        "wall_s_warm": dt,
        "traj_per_s": B / dt,
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
        **_tags("lockstep", T),
    }


def config4(device=DEVICE, dtype=torch.float32, B=16, T=1000, **kw):
    """3-state model, T=1000, batched lockstep AMIS."""
    model = rouse_model(device, dtype, looppositions=THREE_STATES)
    truths, _, batch = config4_data(model, B, T)
    res, dt = _lockstep(model, batch, 4, {**LOCKSTEP_KW, "k_max": 6, **kw}, device)
    return {
        "config": 4,
        "B": B,
        "T": T,
        "n_states": 3,
        "wall_s_warm": dt,
        "traj_per_s": B / dt,
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
        **_tags("lockstep", T),
    }


def config5(postproc=False, device=DEVICE, dtype=torch.float32, B_total=10240,
            chunk=1024, T=100, **kw):
    """10,240 trajectories in chunks of 1,024 (no warm repeat: the wall
    includes the kernels' first launches). With ``postproc=True`` each
    chunk also climbs the MAP profiles' boundaries and reads the
    evidence-averaged marginal posterior of the climbed states;
    ``mean_credibility`` is its mean over all frames."""
    model = rouse_model(device, dtype)
    rng = np.random.default_rng(5)
    acc_frames = acc_switch = acc_post = cred = 0.0
    n_chunks = B_total // chunk
    _sync(device)
    t0 = time.perf_counter()
    for c in range(n_chunks):
        truths = truth_profiles(rng, chunk, T, 2)
        batch = model.trajectories_from_loopingprofiles(
            truths, generator=torch.Generator(device=model.device).manual_seed(100 + c))
        res = sample_batch(model, batch, **{**LOCKSTEP_KW, **kw}, marginals=postproc,
                           generator=torch.Generator().manual_seed(200 + c))
        profiles = res.best_profile()
        acc_frames += _accuracy(profiles, truths)
        acc_switch += _switch_accuracy(res.best_k(), truths)
        if postproc:
            opt, _ = optimize_boundary_batch(profiles, batch, model)
            acc_post += _accuracy(opt, truths)
            logpost = res.log_marginal_posterior(dE="average")      # (B, n, T)
            with np.errstate(under="ignore"):
                picked = np.take_along_axis(np.exp(logpost),
                                            np.asarray(opt)[:, None, :], axis=1)
            cred += float(np.mean(picked))
    _sync(device)
    dt = time.perf_counter() - t0
    out = {
        "config": 5,
        "B": n_chunks * chunk,
        "wall_minutes": dt / 60,
        "traj_per_s": n_chunks * chunk / dt,
        "frame_accuracy": acc_frames / n_chunks,
        "switch_count_accuracy": acc_switch / n_chunks,
        **_tags("lockstep", T),
    }
    if postproc:
        out["postproc"] = True
        out["frame_accuracy_postproc"] = acc_post / n_chunks
        out["mean_credibility"] = cred / n_chunks
    return out


def config6(device=DEVICE, dtype=torch.float32, B=64, T=100, **kw):
    """GenericGaussianModel dataset inference (device interval tables)."""
    model, truths, _, _, batch = ggm_data(6, B, T, device=device, dtype=dtype)

    def run():
        model.clear_memo()            # warm = table build + inference
        return sample_batch(model, batch, **{**GGM_KW, **kw},
                            generator=torch.Generator().manual_seed(6))

    res, dt = _warm(run, device)
    return {
        "config": 6,
        "model": "GenericGaussianModel",
        "B": B,
        "wall_s_warm": dt,
        "traj_per_s": B / dt,
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
        **_tags(None, T),
    }


def config7(device=DEVICE, dtype=torch.float32, B=16, T=1000, T_band=128, **kw):
    """GGM long-T: banded interval tables (T_band=128), B=16, T=1000."""
    model, truths, _, _, batch = ggm_data(7, B, T, T_band, device=device, dtype=dtype)
    res, dt = _warm(lambda: sample_batch(model, batch,
                                         **{**GGM_KW, "informed_init": True, **kw},
                                         generator=torch.Generator().manual_seed(7)),
                    device)
    return {
        "config": 7,
        "model": "GenericGaussianModel T=1000 banded",
        "B": B,
        "T": T,
        "T_band": T_band,
        "wall_s_warm": dt,
        "traj_per_s": B / dt,
        "frame_accuracy": _accuracy(res.best_profile(), truths),
        "switch_count_accuracy": _switch_accuracy(res.best_k(), truths),
        **_tags(None, T),
    }


RUNNERS = {"2": config2, "3": config3, "4": config4, "5": config5,
           "5p": lambda **kw: config5(postproc=True, **kw), "6": config6,
           "7": config7}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default="2,3,4,6,7")
    ap.add_argument("--out", default="PERF_torch.json")
    ap.add_argument("--matmul", default=bt.config.rouse_matmul(),
                    choices=bt.config.MATMUL_MODES,
                    help="the packed Rouse kernel's matmul tier "
                         "(config.set_rouse_matmul); the port ships 'exact'")
    args = ap.parse_args(argv)
    args.configs = [c.strip() for c in args.configs.split(",")]
    for c in args.configs:
        if c not in RUNNERS:
            raise SystemExit(f"unknown config {c!r}; valid configs: "
                             f"{', '.join(RUNNERS)}")
    return args


def run_configs(configs, matmul, device=DEVICE, **kw):
    """Run ``configs`` under ``matmul``: ``{key: result dict}``, the key
    the config's name, suffixed by any tier other than the port's
    default."""
    shipped = bt.config.rouse_matmul()
    suffix = "" if matmul == shipped else f"_{matmul}"
    info = card() if torch.device(device).type == "cuda" else {
        "name": "cpu", "power_limit": None}
    results = {}
    bt.config.set_rouse_matmul(matmul)
    try:
        for c in configs:
            print(f"== config {c}{suffix} ==", flush=True)
            r = RUNNERS[c](device=device, **kw.get(c, {}))
            r.update(matmul=matmul, device=info)
            results[c + suffix] = r
            print(json.dumps(r), flush=True)
    finally:
        bt.config.set_rouse_matmul(shipped)
    return results


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_e2e_torch.py: no CUDA device (torch.cuda.is_available() "
              "is false); the configs run on the card only", file=sys.stderr)
        return 1
    bt.config.exact_fp32()
    results = run_configs(args.configs, args.matmul)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
