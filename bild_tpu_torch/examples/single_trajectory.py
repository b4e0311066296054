"""
End-to-end example: full adaptive Bayesian inference on one trajectory
(the counterpart of ``examples/single_trajectory.py``).

Run:  python -m bild_tpu_torch.examples.single_trajectory [--device cpu] [--smoke]

The trajectory is drawn by torch's generator, not JAX's, so its numbers
differ from `bild_tpu`'s example; on the CPU it runs in float64.
"""
import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.examples import parse_args, setup


def main(device=None, smoke=None):
    device, dtype, smoke = setup(device, smoke)
    T = 24 if smoke else 100
    model = bt.models.MultiStateRouse(8 if smoke else 20, D=1, k=5, d=3,
                                      localization_error=0.1,
                                      device=device, dtype=dtype)

    # ground truth: a loop over the middle third of the trajectory
    truth = np.zeros(T, dtype=int)
    truth[3 * T // 10: 6 * T // 10] = 1
    traj = model.trajectory_from_loopingprofile(
        truth, generator=torch.Generator(device=device).manual_seed(0))

    res = bt.sample(traj, model,
                    generator=torch.Generator(device=device).manual_seed(1))

    print("evidence over k:", np.round(res.evidence, 2))
    print("best k:", res.best_k())
    best = res.best_profile()
    print("truth   :", "".join(map(str, truth)))
    print("inferred:", "".join(map(str, best[:])))

    refined = bt.postproc.optimize_boundary(best, traj, model)
    print("refined :", "".join(map(str, refined[:])))

    post = res.log_marginal_posterior(dE="average")
    with np.errstate(under="ignore"):
        p_loop = np.exp(post[1])
    print("P(looped) per frame (first 10):", np.round(p_loop[:10], 2))

    acc = float(np.mean(refined[:] == truth))
    print(f"frame accuracy: {acc:.3f}")
    return {"evidence": np.asarray(res.evidence), "best_k": int(res.best_k()),
            "frame_accuracy": acc,
            "inferred_accuracy": float(np.mean(best[:] == truth))}


if __name__ == "__main__":
    args = parse_args(__doc__.strip().splitlines()[0])
    main(device=args.device, smoke=args.smoke)
