"""
Command-line entry point: dataset-scale looping inference (counterpart of
`python -m bild_tpu`).

    python -m bild_tpu_torch DATA.csv --out results.npz [options]

Reads a trajectory table (``traj_id, frame, v0..v{d-1}``; see `io`), runs
`parallel.sample_dataset` on a `MultiStateRouse` looping model and writes
per-trajectory evidence curves, best switch counts and MAP looping
profiles, optionally boundary-optimized (``--optimize-boundaries``) and
summarized into per-state dwell-time survival curves with confidence
intervals (``--dwell-times``). ``--fit-params ROUNDS`` first calibrates
``(D, k)`` by gradient maximum likelihood (`fit.calibrate_rouse`).

The model runs on ``--device`` (default ``cuda``; without a GPU that
raises: pass ``--device cpu``) in ``--dtype`` (default ``float32``), the
counterparts of what `bild_tpu`'s CLI takes from its JAX environment.

Several processes, one per GPU, split a dataset with ``--mesh``: each
joins the process group that ``torchrun`` (or ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) describes and computes on the GPU of its
local rank. With ``--process-local`` each reads only its own CSV shard
(`parallel.sample_dataset_sharded`); without it every process reads the
whole file (`parallel.sample_dataset(mesh=)`). Every process writes its
own ``--out``, all with the same results.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _object_array(seq):
    """1-d object array of per-trajectory arrays. ``np.array(seq,
    dtype=object)`` is not safe here: for ragged 2-d elements with a common
    leading dim (e.g. (n, T_i) marginals) it raises a broadcast error, and
    for equal-length elements it builds a 2-d object array."""
    out = np.empty(len(seq), dtype=object)
    for i, x in enumerate(seq):
        out[i] = np.asarray(x)
    return out


def _parse_looppositions(spec):
    """
    Parse the ``--loop-positions`` grammar into the `MultiStateRouse`
    ``looppositions`` argument: states separated by ``;``, each state
    ``none`` (no extra bond) or ``+``-separated bonds ``left,right[,
    rel_strength]`` (ints; strength float, default 1). Example, the 3-state
    free/full-loop/inner-loop model:

        --loop-positions "none;0,-1;0,10"
    """
    states = []
    for part in spec.split(";"):
        part = part.strip()
        if part.lower() in ("none", ""):
            states.append(None)
            continue
        bonds = []
        for bond in part.split("+"):
            f = [x.strip() for x in bond.split(",")]
            if len(f) not in (2, 3):
                raise ValueError(
                    f"bad bond {bond!r} in --loop-positions (want "
                    f"'left,right' or 'left,right,strength')")
            bonds.append((int(f[0]), int(f[1]))
                         + ((float(f[2]),) if len(f) == 3 else ()))
        states.append(bonds[0] if len(bonds) == 1 else bonds)
    if len(states) < 2:
        raise ValueError("--loop-positions needs >= 2 states")
    return tuple(states)


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m bild_tpu_torch",
        description="BILD looping inference over a trajectory dataset")
    p.add_argument("data", help="CSV/TSV table: traj_id, frame, values...")
    p.add_argument("--out", default="bild_results.npz",
                   help="output npz path (default bild_results.npz)")
    p.add_argument("--two-locus", action="store_true",
                   help="value columns are two loci; model their difference")
    p.add_argument("--localization-error", type=float, default=0.1)
    p.add_argument("--monomers", type=int, default=20,
                   help="Rouse chain length N (default 20)")
    p.add_argument("--D", type=float, default=1.0)
    p.add_argument("--k", type=float, default=5.0)
    p.add_argument("--loop-positions", default=None, metavar="SPEC",
                   help="per-state extra bonds, ';'-separated states of "
                        "'left,right[,strength]' bonds ('+'-separated), "
                        "'none' = no bond. Default 'none;0,-1' (2-state). "
                        "E.g. 3-state: 'none;0,-1;0,10'")
    p.add_argument("--k-max", type=int, default=10,
                   help="max switch count explored (default 10)")
    p.add_argument("--steps-per-k", type=int, default=20)
    p.add_argument("--proposals", type=int, default=128,
                   help="AMIS proposals per step (default 128)")
    p.add_argument("--scout-steps", type=int, default=4,
                   help="two-phase schedule scouting steps (0 = full budget "
                        "for every k)")
    p.add_argument("--refine-top", type=int, default=3)
    p.add_argument("--dE", type=float, default=0.0)
    p.add_argument("--chunk-size", type=int, default=1024)
    p.add_argument("--checkpoint-dir", default=None,
                   help="chunk-granular resume directory")
    p.add_argument("--marginals", action="store_true",
                   help="also compute per-frame state posteriors")
    p.add_argument("--optimize-boundaries", action="store_true",
                   help="greedy boundary refinement of the MAP profiles")
    p.add_argument("--dwell-times", action="store_true",
                   help="per-state dwell-time statistics over the dataset: "
                        "censored samples, Kaplan-Meier survival curves, and "
                        "censored-exponential mean with confidence interval")
    p.add_argument("--fit-params", type=int, default=0, metavar="ROUNDS",
                   help="before the dataset run, calibrate D and k by "
                        "gradient MLE with this many inference/fit "
                        "alternations (bild_tpu_torch.fit.calibrate_rouse) on "
                        "--fit-subset trajectories; the localization error "
                        "stays at --localization-error (0 = off)")
    p.add_argument("--fit-subset", type=int, default=256,
                   help="max trajectories used for --fit-params "
                        "calibration (stacked into one padded batch)")
    p.add_argument("--dt", type=float, default=1.0,
                   help="frame interval in physical time units (dwell times)")
    p.add_argument("--adaptive", action="store_true",
                   help="per-trajectory active-learning schedule "
                        "(evidence-driven budget allocation + certainty-"
                        "based early stopping) instead of the fixed "
                        "lockstep steps-per-k schedule")
    p.add_argument("--mesh", action="store_true",
                   help="split chunks over the ranks of the process group "
                        "(torchrun's environment; one rank without it), "
                        "one GPU per rank")
    p.add_argument("--process-local", action="store_true",
                   help="sharded ingestion: the data argument is THIS "
                        "process's CSV shard (disjoint traj_ids across "
                        "processes); with --mesh the processes agree on the "
                        "schedule and produce results bit-identical to a "
                        "single-process full-data run "
                        "(parallel.sample_dataset_sharded)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default cuda; cpu to run "
                        "without a GPU)")
    p.add_argument("--dtype", default="float32", choices=("float32", "float64"),
                   help="the model's float type (default float32)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.process_local and (args.adaptive or args.optimize_boundaries):
        print("--process-local does not combine with --adaptive/"
              "--optimize-boundaries yet", file=sys.stderr)
        return 1

    import torch
    import torch.distributed as dist

    from . import io as bio
    from .config import resolve_device
    from .models import MultiStateRouse
    from .parallel import make_mesh, sample_dataset, sample_dataset_sharded

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    dtype = getattr(torch, args.dtype)
    mesh = None
    if args.mesh:
        mesh = make_mesh(axis_names=("data",), devices=args.device,
                         distributed=(dist.is_initialized()
                                      or "WORLD_SIZE" in os.environ))
        device = mesh.device

    traj_ids = None
    if args.process_local:
        trajs, traj_ids = bio.load_trajectories_csv(
            args.data, two_locus=args.two_locus,
            localization_error=args.localization_error, return_ids=True,
            dtype=dtype)
    else:
        trajs = bio.load_trajectories_csv(
            args.data, two_locus=args.two_locus,
            localization_error=args.localization_error, dtype=dtype)
    if not trajs:
        print("no trajectories found", file=sys.stderr)
        return 1
    d = trajs[0].d
    if not args.quiet:
        lens = [len(t) for t in trajs]
        print(f"{len(trajs)} trajectories, d={d}, "
              f"T in [{min(lens)}, {max(lens)}]")

    loops = (_parse_looppositions(args.loop_positions)
             if args.loop_positions else (None, (0, -1)))
    model = MultiStateRouse(args.monomers, args.D, args.k, d=d,
                            looppositions=loops,
                            localization_error=args.localization_error,
                            device=device, dtype=dtype)

    fitted = None
    if args.fit_params:
        from .fit import calibrate_rouse
        cal = calibrate_rouse(
            model, trajs[:args.fit_subset], rounds=args.fit_params,
            sample_kwargs=dict(k_max=args.k_max,
                               steps_per_k=args.steps_per_k,
                               N=args.proposals),
            fit_kwargs=dict(fit_localization=False),
            generator=torch.Generator().manual_seed(args.seed + 1))
        model = cal.model
        fitted = (cal.D, cal.k)
        if not args.quiet:
            print(f"calibrated on {min(len(trajs), args.fit_subset)} "
                  f"trajectories: D={cal.D:.4g} (from {args.D:.4g}), "
                  f"k={cal.k:.4g} (from {args.k:.4g})")

    if args.process_local:
        res = sample_dataset_sharded(
            model, trajs, traj_ids, mesh=mesh,
            k_max=args.k_max, steps_per_k=args.steps_per_k,
            N=args.proposals, dE=args.dE,
            scout_steps=args.scout_steps or None,
            refine_top=args.refine_top, marginals=args.marginals,
            chunk_size=args.chunk_size,
            generator=torch.Generator().manual_seed(args.seed),
            checkpoint_dir=args.checkpoint_dir,
            show_progress=not args.quiet)
    else:
        res = sample_dataset(
            model, trajs,
            k_max=args.k_max, steps_per_k=args.steps_per_k, N=args.proposals,
            dE=args.dE,
            scout_steps=args.scout_steps or None, refine_top=args.refine_top,
            marginals=args.marginals,
            chunk_size=args.chunk_size,
            mesh=mesh,
            generator=torch.Generator().manual_seed(args.seed),
            checkpoint_dir=args.checkpoint_dir,
            show_progress=not args.quiet,
            optimize_boundaries=args.optimize_boundaries,
            schedule="adaptive" if args.adaptive else "lockstep")

    best_k = res.best_k()
    profiles = res.best_profile()
    out = {
        "k": res.k,
        "evidence": res.evidence,
        "evidence_se": res.evidence_se,
        "best_k": best_k,
        "lengths": np.array([len(p) for p in profiles]),
        "best_profiles": _object_array(profiles),
    }
    if fitted is not None:
        out["fitted_D"], out["fitted_k"] = fitted
    if args.adaptive and res.evals is not None:
        out["likelihood_evals"] = res.evals
    if args.marginals:
        out["log_marginal_posterior"] = _object_array(
            res.log_marginal_posterior(dE="average"))
    if args.optimize_boundaries:
        out["optimized_profiles"] = _object_array(res.optimized)
        out["boundary_elimination_flag"] = res.eliminated
    if args.dwell_times:
        from . import stats
        source = res.optimized if args.optimize_boundaries else profiles
        for s in range(model.nStates):
            dur, cen = stats.dwell_times(source, s, dt=args.dt)
            out[f"dwell_durations_state{s}"] = dur
            out[f"dwell_censored_state{s}"] = cen
            if np.count_nonzero(~cen):
                out[f"dwell_KM_state{s}"] = stats.KM_survival(dur, cen)
                m, lo, hi = stats.MLE_censored_exponential(dur, cen)
                out[f"dwell_exp_mean_ci_state{s}"] = np.array([m, lo, hi])
                if not args.quiet:
                    print(f"state {s}: {len(dur)} dwells "
                          f"({np.count_nonzero(cen)} censored), exponential "
                          f"mean {m:.3g} (95% CI [{lo:.3g}, {hi:.3g}])")
            elif not args.quiet:
                print(f"state {s}: no fully-observed dwell intervals")
    np.savez(args.out, **out)
    frac_at_cap = float(np.mean(best_k >= args.k_max))
    if frac_at_cap > 0.2:
        print(f"warning: {frac_at_cap:.0%} of trajectories chose "
              f"k = k_max = {args.k_max}; the explored switch-count range "
              f"may be binding - consider raising --k-max", file=sys.stderr)
    if not args.quiet:
        hist = np.bincount(best_k, minlength=args.k_max + 1)
        print(f"switch-count histogram: {hist.tolist()}")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
