"""
Gradient-based calibration of `MultiStateRouse` physical parameters
(counterpart of the Rouse part of `bild_tpu.fit`).

The connectivity Laplacian of each loop state depends only on the bond
structure, never on ``(D, k)``: its eigendecomposition ``A = V diag(lam)
V^T`` is a host float64 constant, and the dynamics are elementwise
functions of the eigenvalues,

    B   = V diag(exp(-k lam dt)) V^T
    Sig = V diag(D/(k lam) (1 - exp(-2 k lam dt))) V^T
    C0  = V diag(D/(k lam)) V^T            (free modes: 2 D dt / pinned 0)

so ``(log D, log k) -> (B, Sig, C0)`` is smooth and closed-form. Free modes
(``lam = 0``) are guarded on both branches of each `torch.where`, so no NaN
reaches the gradient.

The objective runs the plain PyTorch recursion
(`ops.kalman.msrouse_logL_batch`, all trajectories as lanes of one call)
under `torch.autograd`, as `bild_tpu` differentiates its XLA scan and not
a Pallas kernel; `calibration_logL` counts those calls apart from
inference. `torch.optim.Adam` stands in for optax's adam (same defaults:
betas 0.9/0.999, eps 1e-8 outside the square root), in a Python loop. On
the GPU the objective's forward and backward are one CUDA graph: the
recursion is some 10^4 small kernels per step, which launches would
bound.

Typical use, EM-style:

    res = sample_dataset(model, trajs, ...)            # infer profiles
    fit = fit_rouse(model, trajs, res.best_profile())  # refit parameters
    model = fit.model                                  # calibrated model
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .amis.sampler import spawn_generator
from .ops.kalman import msrouse_logL_batch
from .physics.rouse import _FREE_MODE_TOL, _build_laplacian
from .trajectory import Trajectory

__all__ = ["fit_rouse", "FitResult", "make_rouse_nll", "calibrate_rouse",
           "CalibrationResult", "calibration_logL",
           "fit_ggm", "make_ggm_nll", "GGMFitResult", "MSDFamily", "POWERLAW",
           "TWO_LOCUS_ROUSE", "calibrate_ggm", "GGMCalibrationResult"]


def calibration_logL(*args):
    """The M-step's likelihood: `ops.kalman.msrouse_logL_batch` (the plain
    recursion, differentiable), counted in ``calibration_logL.calls`` (on
    the GPU these are the calls that record the CUDA graph; its replays
    call nothing)."""
    calibration_logL.calls += 1
    return msrouse_logL_batch(*args)


calibration_logL.calls = 0


def _spectral_consts(model):
    """Per-state eigendecompositions of the parameter-independent
    Laplacians: ``(lams (n, N), Vs (n, N, N), free (n, N) bool)``, host
    float64."""
    lams, Vs, frees = [], [], []
    for m in model.models:
        A = _build_laplacian(m.N, m.add_bonds)
        lam, V = np.linalg.eigh(A)
        lam = np.clip(lam, 0.0, None)
        lams.append(lam)
        Vs.append(V)
        frees.append(lam <= _FREE_MODE_TOL * max(1.0, float(lam[-1])))
    return np.stack(lams), np.stack(Vs), np.stack(frees)


def _dynamics_from_params(consts, log_D, log_k, dt):
    """Differentiable ``(log D, log k) -> (Bs, Sigs, C0s)`` on ``log_D``'s
    device and in its dtype; the formulas of `physics.rouse.rouse_arrays`,
    with the free-mode division guarded on both branches."""
    like = dict(dtype=log_D.dtype, device=log_D.device)
    lams, Vs, free = consts
    lam = torch.as_tensor(lams, **like)
    V = torch.as_tensor(Vs, **like)
    free = torch.as_tensor(free, device=log_D.device)

    D = torch.exp(log_D)
    k = torch.exp(log_k)
    kl = k * lam                                       # (n, N)
    safe_kl = torch.where(free, 1.0, kl)
    b = torch.exp(-kl * dt)
    sig = torch.where(free, 2.0 * D * dt,
                      D / safe_kl * (1.0 - torch.exp(-2.0 * kl * dt)))
    css = torch.where(free, 0.0, D / safe_kl)

    def sandwich(diag):                                # V diag V^T per state
        return torch.einsum("snm,sm,skm->snk", V, diag, V)

    return sandwich(b), sandwich(sig), sandwich(css)


def _as_batch_arrays(data, device, dtype):
    """Trajectory / TrajectoryBatch / sequence -> ``(data (B, T, d), valid
    (B, T), trajectories or None)`` on ``device``, in ``dtype``."""
    from .parallel import stack_trajectories

    if isinstance(data, Trajectory):
        data, trajs = stack_trajectories([data]), [data]
    elif hasattr(data, "data") and hasattr(data, "valid"):   # TrajectoryBatch
        trajs = None
    else:
        trajs = list(data)
        data = stack_trajectories(trajs)
    return (data.data.to(device=device, dtype=dtype),
            data.valid.to(device=device), trajs)


def _coerce_profiles(profiles, B, T, valid):
    """``(T,)`` / ``(B, T)`` arrays broadcast; ragged sequences (e.g.
    ``sample_dataset(...).best_profile()``) pad to T with state 0 (padding
    frames are invalid, so the value never reaches the likelihood). A
    profile shorter than its trajectory's frame count would score real
    frames as state 0, so that raises. Returns an int numpy ``(B, T)``."""
    if not isinstance(profiles, np.ndarray) or profiles.dtype == object:
        seq = list(profiles)
        if len(seq) and np.ndim(seq[0]) >= 1 \
                and any(len(np.asarray(p)) != T for p in seq):
            if len(seq) != B:
                raise ValueError(f"got {len(seq)} profiles for {B} "
                                 "trajectories")
            valid = np.asarray(valid)
            # frame count = position of each row's last observed frame + 1
            lengths = np.where(valid.any(axis=1),
                               T - np.argmax(valid[:, ::-1], axis=1), 0)
            out = np.zeros((B, T), dtype=np.int32)
            for b, p in enumerate(seq):
                p = np.asarray(p, dtype=np.int32)
                if not lengths[b] <= len(p) <= T:
                    raise ValueError(
                        f"profile {b} has {len(p)} frames but trajectory "
                        f"{b} has {lengths[b]} (batch padded to {T})")
                out[b, :len(p)] = p
            return out
        profiles = np.asarray([np.asarray(p) for p in seq]) \
            if len(seq) and np.ndim(seq[0]) >= 1 else np.asarray(seq)
    return np.broadcast_to(profiles.astype(np.int32), (B, T))


def _resolve_err0(model, trajs, d):
    """The starting (or frozen) localization error, resolved like the
    likelihood (``bild/models.py:255-263``): the model's value if set, else
    the trajectories' metadata. The fit shares one noise level across the
    batch, so heterogeneous per-trajectory errors raise."""
    if model.localization_error is not None:
        err0 = np.asarray(model.localization_error, dtype=float)
    elif trajs is not None:
        errs = np.stack([np.broadcast_to(
            np.asarray(model._get_noise(t), dtype=float), (d,))
            for t in trajs])
        if not (errs == errs[0]).all():
            raise ValueError(
                "trajectories carry heterogeneous localization errors; the "
                "fit shares one noise level across the batch: set "
                "model.localization_error explicitly or fit homogeneous "
                "subsets")
        err0 = errs[0]
    else:
        raise ValueError("fitting a TrajectoryBatch requires "
                         "model.localization_error to be set")
    return np.broadcast_to(err0, (d,))


def make_rouse_nll(model, data, profiles, fit_localization=True,
                   weights=None):
    """
    The differentiable objective, as `bild_tpu.fit.make_rouse_nll`.

    ``data``: a Trajectory, TrajectoryBatch or sequence of Trajectory.
    ``profiles``: ``(T,)`` or ``(B, T)`` ints, or a ragged sequence of
    ``(T_b,)`` profiles; with ``weights (B, M)`` (posterior weights, rows
    summing to 1), a ``(B, M, T)`` array of candidates and the
    posterior-expected objective (soft EM). ``fit_localization``: True /
    "scalar" fits one isotropic error, "vector" one per dimension, False
    freezes it at the model's (or the trajectories') value.

    Returns ``(nll, params0)``: ``nll(params)`` is the negative mean
    log-likelihood per observed scalar, a 0-dim tensor that autograd can
    differentiate; ``params0`` the starting tensors (``log_D``, ``log_k``
    and, when fitted, ``log_err``) on the model's device.
    """
    nll, params0, _ = _build_nll(model, data, profiles, fit_localization,
                                 weights)
    return nll, params0


def _build_nll(model, data, profiles, fit_localization, weights=None):
    """`make_rouse_nll`'s body; also returns the resolved starting error."""
    device, dtype = model.device, model.dtype
    ydata, valid, trajs = _as_batch_arrays(data, device, dtype)
    B, T, d = ydata.shape
    if weights is not None:
        profiles = np.asarray(profiles, dtype=np.int32)
        weights = torch.as_tensor(np.asarray(weights), dtype=dtype,
                                  device=device)
        if profiles.shape != (B, weights.shape[1], T) \
                or tuple(weights.shape) != profiles.shape[:2]:
            raise ValueError(
                f"weighted profiles must be (B={B}, M, T={T}) with (B, M) "
                f"weights; got {profiles.shape} / {tuple(weights.shape)}")
    else:
        profiles = _coerce_profiles(profiles, B, T, valid.cpu().numpy())[:, None, :]
    profiles = torch.as_tensor(np.array(profiles, dtype=np.int32), device=device)

    m0 = model.models[0]
    lams, Vs, free = _spectral_consts(model)
    consts = (torch.as_tensor(lams, dtype=dtype, device=device),
              torch.as_tensor(Vs, dtype=dtype, device=device),
              torch.as_tensor(free, device=device))
    n = len(model.models)
    dt = m0.dt
    w = model.w
    err0 = _resolve_err0(model, trajs, d)

    mode = {True: "scalar", False: "off"}.get(fit_localization,
                                              fit_localization)
    if mode not in ("scalar", "vector", "off"):
        raise ValueError(f"fit_localization: got {fit_localization!r}")

    def param(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    params0 = {"log_D": param(math.log(m0.D)), "log_k": param(math.log(m0.k))}
    s2_frozen = None
    if mode == "scalar":
        params0["log_err"] = param(np.mean(np.log(err0)))
        Cind = np.zeros(d, dtype=np.int32)          # q=1: one covariance copy
    elif mode == "vector":
        params0["log_err"] = param(np.log(err0))
        Cind = np.arange(d, dtype=np.int32)         # q=d: one per dimension
    else:
        # a frozen error merges equal dimensions as the likelihood does
        uniq, Cind = np.unique(err0, return_inverse=True)
        Cind = Cind.astype(np.int32)
        s2_frozen = param(uniq ** 2)
    Cind = torch.as_tensor(Cind, device=device)

    Gs = torch.zeros((n, m0.N, d), dtype=dtype, device=device)
    M0s = torch.zeros((n, m0.N, d), dtype=dtype, device=device)
    n_obs = float(valid.sum()) * d

    def nll(params):
        Bs, Sigs, C0s = _dynamics_from_params(
            consts, params["log_D"], params["log_k"], dt)
        s2 = (s2_frozen if mode == "off"
              else torch.atleast_1d(torch.exp(2.0 * params["log_err"])))
        ll = calibration_logL(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,
                              ydata, valid)                      # (B, M)
        if weights is None:
            return -ll.sum() / n_obs
        ll = torch.where(weights > 0, ll, 0.0)       # mask 0 * (-inf)
        return -(weights * ll).sum() / n_obs

    return nll, params0, err0


def _run_adam(nll, params0, steps, learning_rate):
    """The Adam loop. Returns host ``(params, nll_trace, grad_norm)``;
    ``nll_trace[i]`` is the objective before step i, with the value after
    the last step appended. On the GPU the objective's forward and
    backward run as one CUDA graph; ``_run_adam.graphed`` counts the
    objectives captured."""
    names = list(params0)
    leaves = [params0[k].detach().clone().requires_grad_(True) for k in names]

    def objective(*xs):
        return nll(dict(zip(names, xs)))

    if leaves[0].is_cuda:
        _run_adam.graphed += 1
        objective = torch.cuda.make_graphed_callables(objective, tuple(leaves))
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    trace = []
    for _ in range(steps):
        opt.zero_grad()
        val = objective(*leaves)
        val.backward()
        opt.step()
        trace.append(val.detach().clone())   # a graph's output is reused
    val = objective(*leaves)
    grads = torch.autograd.grad(val, leaves)
    gnorm = torch.sqrt(sum((g ** 2).sum() for g in grads))
    trace.append(val.detach().clone())
    return ({k: v.detach().cpu().numpy() for k, v in zip(names, leaves)},
            torch.stack(trace).cpu().numpy().astype(float), float(gnorm))


_run_adam.graphed = 0


def _rebuild_model(model, D, k, err):
    """A `MultiStateRouse` like ``model`` (loop structure, measurement, dt,
    transitions, device, dtype) with new ``(D, k, localization_error)``."""
    from .models import MultiStateRouse

    m0 = model.models[0]
    fitted = MultiStateRouse(
        m0.N, D, k, d=model.d,
        looppositions=[m.add_bonds for m in model.models],
        measurement=np.asarray(model.measurement),
        localization_error=np.asarray(err, dtype=float).copy(),
        dt=m0.dt, device=model.device, dtype=model.dtype)
    fitted.transitions = model.transitions.copy()
    return fitted


@dataclasses.dataclass
class FitResult:
    """Outcome of `fit_rouse`. ``nll_trace[0]`` is the initial objective."""
    D: float
    k: float
    localization_error: np.ndarray        # (d,): fitted or frozen
    params: dict                          # optimized parameters (numpy)
    nll_trace: np.ndarray                 # (steps + 1,)
    grad_norm: float                      # at the optimum
    model: object                         # the calibrated MultiStateRouse

    @property
    def converged(self) -> bool:
        """Heuristic: relative objective change over the last 10% of steps."""
        tail = max(2, len(self.nll_trace) // 10)
        a, b = self.nll_trace[-tail], self.nll_trace[-1]
        return bool(abs(a - b) <= 1e-6 * max(1.0, abs(b)))


def fit_rouse(model, data, profiles, *, fit_localization=True,
              steps: int = 300, learning_rate: float = 0.05,
              weights=None) -> FitResult:
    """
    Maximum-likelihood calibration of ``(D, k[, localization_error])``
    given trajectories and their looping profiles, in log space, with Adam
    (`bild_tpu.fit.fit_rouse` also takes another optax optimizer; here it
    is always Adam). Arguments as `make_rouse_nll`.
    """
    nll, params0, err0 = _build_nll(model, data, profiles, fit_localization,
                                    weights)
    params, trace, gnorm = _run_adam(nll, params0, steps, learning_rate)
    D = float(np.exp(params["log_D"]))
    k = float(np.exp(params["log_k"]))
    if fit_localization:
        err = np.broadcast_to(np.exp(np.asarray(params["log_err"], dtype=float)),
                              (model.d,))
    else:
        err = err0
    return FitResult(D=D, k=k, localization_error=err, params=params,
                     nll_trace=trace, grad_norm=gnorm,
                     model=_rebuild_model(model, D, k, err))


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of `calibrate_rouse`: the calibrated model, the last
    inference results and the per-round fits."""
    model: object                         # calibrated MultiStateRouse
    results: object     # final round's BatchResults / DatasetResults
    fits: list                            # FitResult per round
    # final MAP profiles: (B, T) array (engine="batch") or ragged list of
    # (T_i,) arrays (engine="dataset")
    profiles: object
    # round-0 neutral (constant-profile) fit when init="neutral"; its nll is
    # not comparable to fits[i].nll_trace (other conditioning profiles)
    pre_fit: object = None

    @property
    def D(self):
        return self.fits[-1].D

    @property
    def k(self):
        return self.fits[-1].k

    @property
    def localization_error(self):
        return self.fits[-1].localization_error


def calibrate_rouse(model, data, *, rounds: int = 2,
                    mode: str = "hard", ensemble: int = 16,
                    init: str = "neutral", engine: str = "batch",
                    sample_kwargs: dict | None = None,
                    fit_kwargs: dict | None = None,
                    generator: torch.Generator | None = None
                    ) -> CalibrationResult:
    """
    Joint profile inference and parameter calibration by EM alternation,
    as `bild_tpu.fit.calibrate_rouse`: each round runs lockstep inference
    (`parallel.sample_batch`, or `parallel.sample_dataset` with
    ``engine="dataset"``) at the current parameters, then refits them
    (`fit_rouse`). ``mode="hard"`` fits to each trajectory's MAP profile,
    ``"soft"`` to its ``ensemble`` highest-weight sampled profiles, weighted
    (``engine="batch"`` only). ``init="neutral"`` first fits against the
    constant ground-state profile (no sampling), which widens EM's basin;
    ``"model"`` starts at the model's parameters. ``generator`` (a
    `torch.Generator`, default seeded 0) seeds the inference passes, one
    generator spawned from it per round.
    """
    from .parallel import sample_batch, sample_dataset, stack_trajectories

    if mode not in ("hard", "soft"):
        raise ValueError(f"mode must be 'hard' or 'soft', got {mode!r}")
    if init not in ("neutral", "model"):
        raise ValueError(f"init must be 'neutral' or 'model', got {init!r}")
    if engine not in ("batch", "dataset"):
        raise ValueError(f"engine must be 'batch' or 'dataset', got "
                         f"{engine!r}")
    if engine == "dataset" and mode == "soft":
        raise ValueError("engine='dataset' supports mode='hard' only "
                         "(DatasetResults carries no profile ensembles)")

    if isinstance(data, Trajectory):
        trajs = [data]
    elif hasattr(data, "data") and hasattr(data, "valid"):  # TrajectoryBatch
        if engine == "dataset":
            raise ValueError("engine='dataset' needs a Trajectory "
                             "sequence (it buckets ragged lengths itself)")
        trajs = None
    else:
        trajs = list(data)
    if engine == "batch":
        batch = data if trajs is None else stack_trajectories(trajs)
        fit_data = batch
    else:
        batch = None
        fit_data = trajs
    if model.localization_error is None:
        # lockstep sampling (the E-step) needs a model-level noise
        err = _resolve_err0(model, trajs, model.d)
        m0 = model.models[0]
        model = _rebuild_model(model, m0.D, m0.k, err)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    sample_kwargs = dict(sample_kwargs or {})
    fit_kwargs = dict(fit_kwargs or {})
    if mode == "soft":
        sample_kwargs["ensemble"] = ensemble

    pre_fit = None
    if init == "neutral":
        if engine == "batch":
            neutral = np.zeros((batch.B, batch.T), dtype=int)
        else:
            neutral = [np.zeros(len(t), dtype=int) for t in trajs]
        pre_fit = fit_rouse(model, fit_data, neutral, **fit_kwargs)
        model = pre_fit.model

    fits, res, profiles = [], None, None
    for _ in range(rounds):
        sub = spawn_generator(generator)
        if engine == "dataset":
            res = sample_dataset(model, trajs, generator=sub, **sample_kwargs)
            profiles = res.best_profile()            # ragged list
            fit = fit_rouse(model, fit_data, profiles, **fit_kwargs)
        else:
            res = sample_batch(model, batch, generator=sub, **sample_kwargs)
            profiles = np.asarray(res.best_profile())
            if mode == "soft":
                profs, weights = res.profile_ensemble()
                fit = fit_rouse(model, fit_data, profs, weights=weights,
                                **fit_kwargs)
            else:
                fit = fit_rouse(model, fit_data, profiles, **fit_kwargs)
        fits.append(fit)
        model = fit.model

    return CalibrationResult(model=model, results=res, fits=fits,
                             profiles=profiles, pre_fit=pre_fit)


# GGM MSD-parameter calibration lives in its own module; re-exported here so
# that `fit` is the single calibration namespace
from .fit_ggm import (fit_ggm, make_ggm_nll, GGMFitResult,  # noqa: E402,F401
                      MSDFamily, POWERLAW, TWO_LOCUS_ROUSE,
                      calibrate_ggm, GGMCalibrationResult)
