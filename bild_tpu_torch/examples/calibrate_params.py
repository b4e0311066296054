"""
End-to-end example: calibrate the physical model by gradient-based maximum
likelihood, then run inference with the calibrated model (the counterpart
of ``examples/calibrate_params.py``).

The likelihood is differentiable, so the same recursion both scores
looping profiles and fits ``(D, k, localization_error)`` (`fit.fit_rouse`,
Adam in log space; its objective runs the plain PyTorch recursion under
autograd, as one CUDA graph on the GPU). Inference after it runs the CUDA
kernel.

Run:  python -m bild_tpu_torch.examples.calibrate_params [--device cpu] [--smoke]

The profiles come from the same numpy draws as in `bild_tpu`'s example;
the trajectories are drawn by torch's generator, so the fitted values
differ from `bild_tpu`'s by the spread of the estimate. On the CPU it runs
in float64.
"""
import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.examples import parse_args, setup
from bild_tpu_torch.fit import fit_rouse
from bild_tpu_torch.parallel import sample_batch


def main(device=None, smoke=None):
    device, dtype, smoke = setup(device, smoke)
    B = 4 if smoke else 24
    T = 24 if smoke else 100
    N = 6 if smoke else 20
    steps = 40 if smoke else 300

    D_true, k_true, err_true = 1.0, 5.0, 0.1
    truth_model = bt.models.MultiStateRouse(N, D_true, k_true, d=3,
                                            localization_error=err_true,
                                            device=device, dtype=dtype)

    # simulate a dataset with known looping profiles
    rng = np.random.default_rng(8)
    profiles = np.zeros((B, T), dtype=int)
    for b in range(B):
        t0 = rng.integers(0, T // 2)
        profiles[b, t0:t0 + rng.integers(T // 4, T // 2)] = 1
    batch = truth_model.trajectories_from_loopingprofiles(
        profiles, generator=torch.Generator(device=device).manual_seed(3))

    # start from deliberately wrong parameters (x2 off) and calibrate;
    # in real use the profiles would come from res.best_profile() of an
    # inference pass with the uncalibrated model (EM-style alternation)
    start = bt.models.MultiStateRouse(N, 2 * D_true, 0.5 * k_true, d=3,
                                      localization_error=2 * err_true,
                                      device=device, dtype=dtype)
    fit = fit_rouse(start, batch, profiles, steps=steps, learning_rate=0.05)
    print(f"nll: {fit.nll_trace[0]:.4f} -> {fit.nll_trace[-1]:.4f} "
          f"(grad norm {fit.grad_norm:.1e})")
    print(f"D: {fit.D:.3f} (true {D_true}), k: {fit.k:.3f} (true {k_true}), "
          f"localization error: {fit.localization_error[0]:.3f} "
          f"(true {err_true})")

    # inference with the calibrated model
    res = sample_batch(fit.model, batch, k_max=2 if smoke else 4,
                       steps_per_k=4 if smoke else 10,
                       N=32 if smoke else 128,
                       generator=torch.Generator().manual_seed(4))
    acc = float(np.mean(np.asarray(res.best_profile()) == profiles))
    print(f"frame accuracy with calibrated model: {acc:.3f}")
    return {"D": fit.D, "k": fit.k,
            "localization_error": float(fit.localization_error[0]),
            "nll": (float(fit.nll_trace[0]), float(fit.nll_trace[-1])),
            "frame_accuracy": acc}


if __name__ == "__main__":
    args = parse_args(__doc__.strip().splitlines()[0])
    main(device=args.device, smoke=args.smoke)
