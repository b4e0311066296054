"""
Example: inference with the GenericGaussianModel (GGM) (the counterpart of
``examples/ggm_model.py``).

The GGM describes each looping state as an arbitrary Gaussian process given
by its MSD: useful when the Rouse picture does not apply or for a
model-agnostic check. It runs device-batched through a precomputed
interval table, and runs no Rouse kernel.

Run:  python -m bild_tpu_torch.examples.ggm_model [--device cpu] [--smoke]

The trajectories come from the same numpy draws as in `bild_tpu`'s
example, so the data are the same; the samplers draw from torch's
generators. On the CPU it runs in float64. With ``smoke``, `sample()`
stops at ``k_max=4`` (the default 20 opens up to 18 switch counts on the
tiny, uninformative trajectory: minutes on the CPU).
"""
import numpy as np
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.examples import parse_args, setup
from bild_tpu_torch.fit import fit_ggm
from bild_tpu_torch.models import GenericGaussianModel as GGM
from bild_tpu_torch.parallel import sample_dataset


def main(device=None, smoke=None):
    device, dtype, smoke = setup(device, smoke)
    # two states, both two-locus Rouse-like MSDs with different plateau:
    # state 0 = unlooped (large G), state 1 = looped (small G)
    model = GGM([
        [(GGM.MSD_function_twoLocusRouse(G=1.0, J=5.0), 0.1, 0)],
        [(GGM.MSD_function_twoLocusRouse(G=0.2, J=1.0), 0.1, 0)],
    ], device=device, dtype=dtype)

    T, B = (24, 3) if smoke else (100, 16)
    rng = np.random.default_rng(0)
    true = np.zeros(T, dtype=int)
    true[3 * T // 10: 6 * T // 10] = 1
    trajs = [model.trajectory_from_loopingprofile(true, rng=rng)
             for _ in range(B)]

    # quick per-frame guess
    guess = model.initial_loopingprofile(trajs[0])
    guess_acc = float(np.mean(np.asarray(guess[:]) == true))
    print("per-frame MLE guess accuracy:", guess_acc)

    # single-trajectory adaptive inference with DP-segmentation seeding
    res = bt.sample(trajs[0], model, k_max=4 if smoke else 20,
                    generator=torch.Generator(device=device).manual_seed(1),
                    sampler_kw={"informed_init": True})
    single_acc = float(np.mean(np.asarray(res.best_profile()[:]) == true))
    print("adaptive: best_k =", res.best_k(), "accuracy =", single_acc)

    # dataset mode (scouted schedule)
    ds = sample_dataset(model, trajs, k_max=2 if smoke else 4,
                        steps_per_k=3 if smoke else 12, N=32 if smoke else 128,
                        scout_steps=None if smoke else 4, refine_top=3,
                        informed_init=True,
                        generator=torch.Generator().manual_seed(2))
    accs = [float(np.mean(p == true)) for p in ds.best_profile()]
    hist = np.bincount(ds.best_k(), minlength=5).tolist()
    print(f"dataset: mean frame accuracy {np.mean(accs):.3f} over "
          f"{len(trajs)} trajectories, best_k histogram {hist}")

    # MSD-parameter calibration through the differentiable likelihood,
    # conditioned on the inferred looping profiles
    spec = [  # start ~40% off the truth
        [("twoLocusRouse", dict(G=1.4, J=3.5), 0.1, 0)],
        [("twoLocusRouse", dict(G=0.13, J=1.5), 0.1, 0)],
    ]
    fit = fit_ggm(spec, trajs, np.stack(ds.best_profile()),
                  steps=50 if smoke else 300, device=device, dtype=dtype)
    print("fitted MSD parameters (true: G=1/J=5, G=0.2/J=1):",
          [{k: round(v, 3) for k, v in p.items()}
           for p in fit.parameters])
    return {"guess_accuracy": guess_acc, "best_k": int(res.best_k()),
            "single_accuracy": single_acc,
            "dataset_accuracy": float(np.mean(accs)), "k_histogram": hist,
            "parameters": fit.parameters}


if __name__ == "__main__":
    args = parse_args(__doc__.strip().splitlines()[0])
    main(device=args.device, smoke=args.smoke)
