"""
End-to-end example: dataset-scale looping inference (the counterpart of
``examples/infer_dataset.py``).

1. Load trajectories from a CSV table (native C++ parser) or synthesize them.
2. `sample_dataset`: buckets ragged lengths, chunks, lockstep-infers with
   the scout/refine budget schedule on a one-rank mesh.
3. Report per-trajectory best profiles + switch-count posterior summary.

Run:  python -m bild_tpu_torch.examples.infer_dataset [dataset.csv] [--device cpu] [--smoke]

The synthesized looping profiles come from the same numpy draws as in
`bild_tpu`'s example; the trajectories are drawn by torch's generator in
one batch (not per trajectory from split JAX keys), so their numbers
differ. Synthesized data also prints the accuracy against the truths. On
the CPU it runs in float64.
"""
import time

import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch import stats
from bild_tpu_torch.examples import parse_args, setup
from bild_tpu_torch.parallel import make_mesh, sample_dataset


def synthesize(model, B=64, T=100, seed=0):
    """``(trajectories, truths (B, T))``: 70 % of the profiles hold one loop
    between two random frames."""
    rng = np.random.default_rng(seed)
    profs = np.zeros((B, T), dtype=int)
    for i in range(B):
        if rng.random() < 0.7:
            a, b = sorted(rng.integers(1, T - 1, size=2))
            profs[i, a:b] = 1
    batch = model.trajectories_from_loopingprofiles(
        profs, generator=torch.Generator(device=model.device).manual_seed(seed))
    trajs = [bt.Trajectory(data=batch.data[i], valid=batch.valid[i],
                           localization_error=np.full(model.d, 0.1))
             for i in range(B)]
    return trajs, profs


def main(csv_path=None, device=None, smoke=None):
    device, dtype, smoke = setup(device, smoke)
    # flagship 2-state (unlooped/looped) Rouse model, dual-color 3d readout
    model = bt.models.MultiStateRouse(8 if smoke else 20, D=1, k=5, d=3,
                                      localization_error=0.1,
                                      device=device, dtype=dtype)

    truths = None
    if csv_path is not None:
        trajs = bt.io.load_trajectories_csv(csv_path, two_locus=True,
                                            localization_error=0.1, dtype=dtype)
        print(f"loaded {len(trajs)} trajectories from {csv_path}")
    else:
        trajs, truths = (synthesize(model, B=6, T=24) if smoke
                         else synthesize(model))
        print(f"synthesized {len(trajs)} trajectories")

    mesh = make_mesh(devices=device)
    print(f"devices: {mesh.shape['data']}")

    # sample_dataset owns bucketing, chunking, and original-order
    # reassembly; the scouted schedule spends the full budget only on each
    # trajectory's most plausible switch counts. (For manual control over
    # buckets, see `bucket_trajectories` + `sample_batch`.)
    t0 = time.time()
    res = sample_dataset(model, trajs, k_max=2 if smoke else 4,
                         steps_per_k=3 if smoke else 15, N=32 if smoke else 128,
                         scout_steps=None if smoke else 4, refine_top=3,
                         informed_init=True, mesh=mesh,
                         generator=torch.Generator().manual_seed(42))
    best_k = res.best_k(dE=0)
    profiles = res.best_profile()
    hist = np.bincount(best_k, minlength=5)
    print(f"k histogram {hist}")
    for i in range(min(3, len(trajs))):
        print(f"  traj {i}: k={best_k[i]}, "
              f"profile {''.join(map(str, profiles[i][:40]))}...")

    # dataset-level dwell-time statistics: censored samples per state ->
    # exponential mean with confidence interval (stats.dwell_times bridges
    # inferred profiles to the survival estimators)
    dwells = {}
    for s in range(model.nStates):
        dur, cen = stats.dwell_times(profiles, s)
        if np.count_nonzero(~cen):
            m, lo, hi = stats.MLE_censored_exponential(dur, cen)
            dwells[s] = (int(dur.size), float(m), float(lo), float(hi))
            print(f"  state {s}: {dur.size} dwells, exp mean {m:.2f} frames "
                  f"(95% CI [{lo:.2f}, {hi:.2f}])")
    wall = time.time() - t0
    print(f"total wall: {wall:.1f}s")

    out = {"n_trajectories": len(trajs), "k_histogram": hist, "best_k": best_k,
           "dwells": dwells, "wall_s": wall}
    if truths is not None:
        true_k = np.sum(truths[:, 1:] != truths[:, :-1], axis=1)
        out["frame_accuracy"] = float(np.mean(np.stack(profiles) == truths))
        out["switch_count_accuracy"] = float(np.mean(best_k == true_k))
        print(f"against the synthesized truths: frame accuracy "
              f"{out['frame_accuracy']:.3f}, switch-count accuracy "
              f"{out['switch_count_accuracy']:.3f}")
    return out


if __name__ == "__main__":
    args = parse_args(__doc__.strip().splitlines()[0], csv=True)
    main(args.csv, device=args.device, smoke=args.smoke)
