"""
Checkpoints of `sample()` results (counterpart of
`bild_tpu.utils.checkpoint`).

A checkpoint is one ``.npz``: the trajectory (``traj_*``), the diagnostics
log (``log_*``), each sampler's `AmisState` buffers (``s{i}_{field}``), its
stream key (``s{i}_key``: the int64 key of its `lanes.LaneRNG`, `bild_tpu`'s
``key_data``), its exhaustive ensemble if it has one (``s{i}_ex_*``), and a
JSON ``__meta__``
with the samplers' settings and the model's likelihood fingerprint. The
model itself is not stored: `load_results` takes it as an argument and
refuses one with another fingerprint. A loaded sampler resumes with
exactly the step the saved one would have taken next.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..amis.sampler import AmisState, FixedkSampler
from ..infer.core import SamplingResults
from ..lanes import LaneRNG
from ..trajectory import Trajectory

__all__ = ["save_results", "load_results"]

_STATE_FIELDS = ("ss", "thetas", "logLs", "logdeltas", "a_params", "logps",
                 "evidences", "n_steps", "mom_ok")


def save_results(path, results: SamplingResults):
    """Write a `SamplingResults` to ``path`` (.npz)."""
    arrays = {}
    meta = {"dE": results.dE, "samplers": [],
            "log_keys": list(results.log.keys())}
    model = results.samplers[0].model if results.samplers else None
    fp = getattr(model, "likelihood_fingerprint", lambda: None)()
    if fp is not None:
        meta["model_fingerprint"] = fp

    traj = results.traj
    arrays["traj_data"] = traj.data.cpu().numpy()
    arrays["traj_valid"] = traj.valid.cpu().numpy()
    if traj.localization_error is not None:
        arrays["traj_locerr"] = np.asarray(traj.localization_error)
    for key, val in results.log.items():
        arrays[f"log_{key}"] = np.asarray(val)

    for i, s in enumerate(results.samplers):
        degenerate = not hasattr(s, "_lane")      # k >= T: no state
        smeta = {"k": s.k, "N": s.N, "brakes": list(s.brakes),
                 "max_fev": s.max_fev, "max_fcomplete": s.max_fcomplete,
                 "exhausted": bool(s.exhausted),
                 "informed_init": bool(s.informed_init),
                 "evidences": [list(map(float, e)) for e in s.evidences],
                 "degenerate": degenerate,
                 "has_exhaustive": s._exhaustive is not None}
        if not degenerate:
            for f, v in s.state.to_numpy().items():
                arrays[f"s{i}_{f}"] = np.asarray(v)
            arrays[f"s{i}_key"] = s._rng.keys.cpu().numpy()
        if smeta["has_exhaustive"]:
            for kk, vv in s._exhaustive.items():
                arrays[f"s{i}_ex_{kk}"] = np.asarray(vv)
        meta["samplers"].append(smeta)

    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_results(path, model) -> SamplingResults:
    """
    Restore a `SamplingResults` written by `save_results`, on ``model``'s
    device and in its dtype. ``model`` must be the one used at save time:
    a model with another likelihood fingerprint raises. Each sampler is
    rebuilt by `FixedkSampler`'s constructor, then its state (the device
    step count from ``n_steps``), evidences, exhaustive ensemble and stream
    key (on the model's device) are restored. A checkpoint whose key is no
    int64 stream key (one written when the samplers drew from a
    `torch.Generator`, whose state it holds) raises: it cannot resume on
    the bits it was written with.
    """
    with np.load(path, allow_pickle=False) as zf:
        arrays = {k: zf[k] for k in zf.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))

    fp_saved = meta.get("model_fingerprint")
    if fp_saved is not None:
        fp_now = getattr(model, "likelihood_fingerprint", lambda: None)()
        if fp_now is not None and fp_now != fp_saved:
            raise ValueError(
                f"{path}: model does not match the one used at save time "
                "(likelihood fingerprint mismatch): resuming these samplers "
                "with different parameters would mix results")

    device, dtype = model.device, model.dtype
    traj = Trajectory(
        data=torch.as_tensor(arrays["traj_data"], dtype=dtype, device=device),
        valid=torch.as_tensor(arrays["traj_valid"], device=device),
        localization_error=arrays.get("traj_locerr"))

    samplers = []
    for i, smeta in enumerate(meta["samplers"]):
        k_pad = (arrays[f"s{i}_ss"].shape[-1] - 1 if not smeta["degenerate"]
                 else None)
        if not smeta["degenerate"] and model.nStates != arrays[f"s{i}_logps"].shape[1]:
            raise ValueError(f"{path}: sampler {i} has "
                             f"{arrays[f's{i}_logps'].shape[1]} states, the "
                             f"model {model.nStates}")
        s = FixedkSampler(traj, model, smeta["k"], N=smeta["N"],
                          concentration_brake=smeta["brakes"][0],
                          polarization_brake=smeta["brakes"][1],
                          max_fev=smeta["max_fev"],
                          max_fcomplete=smeta["max_fcomplete"],
                          generator=torch.Generator(device=device),
                          k_pad=k_pad, informed_init=smeta["informed_init"])
        s.evidences = [tuple(e) for e in smeta["evidences"]]
        s.exhausted = smeta["exhausted"]
        if not smeta["degenerate"]:
            key = arrays[f"s{i}_key"]
            if key.dtype != np.int64 or key.shape != (1,):
                raise ValueError(
                    f"{path}: sampler {i}'s key is not an int64 stream key "
                    f"(dtype {key.dtype}, shape {key.shape}): the checkpoint "
                    "holds a torch.Generator state from before the samplers "
                    "drew from counter-based streams, and cannot resume on "
                    "the bits it was written with")
            state = {f: arrays[f"s{i}_{f}"] for f in _STATE_FIELDS}
            n_steps = int(state["n_steps"])
            s._lane = AmisState.from_numpy(
                {**{f: state[f][None] for f in _STATE_FIELDS[:-2]},
                 "n_steps": n_steps,
                 "mom_ok": np.asarray(state["mom_ok"])[None]},
                device=device, dtype=dtype)
            s._lane.n_steps = torch.full((1,), n_steps, dtype=torch.long,
                                         device=device)
            s._steps_host = n_steps
            s._rng = LaneRNG(torch.as_tensor(key, device=device))
        s._exhaustive = ({kk[len(f"s{i}_ex_"):]: v for kk, v in arrays.items()
                          if kk.startswith(f"s{i}_ex_")}
                         if smeta["has_exhaustive"] else None)
        samplers.append(s)

    res = SamplingResults(traj, model, meta["dE"], samplers, log=None)
    res.log = {k[len("log_"):]: v for k, v in arrays.items()
               if k.startswith("log_")}
    return res
