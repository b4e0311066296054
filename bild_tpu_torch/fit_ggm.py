"""
Gradient-based MSD-parameter calibration for `GenericGaussianModel`
(counterpart of `bild_tpu.fit_ggm`).

The interval likelihood is rebuilt as a differentiable PyTorch function of
the MSD parameters, so the profile-CONDITIONED maximum-likelihood fit comes
from the same autograd machinery as `fit.fit_rouse`: each state's MSD is
fit exactly on the frames that state governs, which an external
full-trajectory MSD fit cannot do for a switching process.

Design: the GGM likelihood precomputes O(n T^2) interval TABLES
(`models/ggm.py`) because inference scores every possible interval. A fit
conditions on FIXED profiles, so only the intervals actually present
matter, a handful per trajectory. Those windows are extracted once on the
host (static shapes: padded to the longest window), and the objective
evaluates them with the same two covariance forms as the `logL_host`
oracle:

- ``ss_order = 0`` (positionally stationary): ``C_ij = (plateau -
  MSD(|t_i - t_j|)) / 2`` over the window's observed frames; for
  non-initial intervals the likelihood is CONDITIONED on the overlap
  frame, computed as ``log N(window) - log N(first frame)``: identical
  to the reference's Schur downdate but expressed without slicing, so it
  batches over padded windows.
- ``ss_order = 1`` (increment-stationary): the increment covariance of
  `physics.gp.msd2C`, built from four static lag-index gathers.

The only parameter-dependent quantities are each state's MSD at integer
lags 0..T (one ``(T+1,)`` table per fitted unit) and its plateau; window
covariances are gathers from those tables, and each group of windows is
one batched Cholesky (`torch.linalg.cholesky_ex`, no error fetch) that
autograd differentiates. Imaging artifacts (localization noise
``2*noise2``, Savin-Doyle motion blur) are applied to the table with the
same Gauss-Legendre quadrature as the host `physics.gp.imaging` decorator.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .amis.sampler import spawn_generator
from .config import DEFAULT_DEVICE, resolve_device
from .profiles import Loopingprofile
from .trajectory import Trajectory

__all__ = ["fit_ggm", "make_ggm_nll", "GGMFitResult", "MSDFamily",
           "POWERLAW", "TWO_LOCUS_ROUSE", "calibrate_ggm",
           "GGMCalibrationResult"]

LOG_2PI = float(np.log(2.0 * np.pi))
_GL_POINTS = 32

@dataclasses.dataclass(frozen=True)
class MSDFamily:
    """A differentiable MSD family.

    ``msd(lags, **p)`` must be a PyTorch function (differentiable by
    autograd) of a tensor of strictly positive lags (frames) and the
    fitted parameters (0-dim tensors); ``plateau(**p)`` returns
    ``MSD(inf)`` or is None for unbounded MSDs (which then cannot serve
    positionally-stationary ``ss_order=0`` states); ``build(noise2, f,
    **p)`` constructs the host msd function used to rebuild a
    `GenericGaussianModel` at the fitted parameters. All fields are fit
    in log space (they are positive scale/shape parameters)."""

    name: str
    fields: tuple
    msd: callable
    plateau: callable | None
    build: callable


def _powerlaw_msd(lags, G, a):
    return G * lags**a


def _two_locus_msd_torch(lags, G, J):
    # physics.rouse.two_locus_msd on tensors (lags > 0, finite)
    u = 2.0 * J / (G * torch.sqrt(math.pi * lags))
    return (G * torch.sqrt(lags) * (1.0 - torch.exp(-u * u))
            + 2.0 * J * torch.special.erfc(u))


def _build_powerlaw(noise2, f, G, a):
    from .models import GenericGaussianModel
    return GenericGaussianModel.MSD_function_powerlaw(
        G=G, a=a, noise2=noise2, motion_blur_f=f)


def _build_two_locus(noise2, f, G, J):
    from .models import GenericGaussianModel
    return GenericGaussianModel.MSD_function_twoLocusRouse(
        G=G, J=J, noise2=noise2, motion_blur_f=f)


POWERLAW = MSDFamily("powerlaw", ("G", "a"), _powerlaw_msd, None,
                     _build_powerlaw)
TWO_LOCUS_ROUSE = MSDFamily("twoLocusRouse", ("G", "J"), _two_locus_msd_torch,
                            lambda G, J: 2.0 * J, _build_two_locus)

_FAMILIES = {f.name: f for f in (POWERLAW, TWO_LOCUS_ROUSE)}


def _msd_table(family, p, noise2, f, T, dtype, device):
    """(T+1,) MSD at integer lags with imaging artifacts, and the plateau
    (None for unbounded MSDs). ``noise2`` may be a tensor (fitted) or a
    python float (frozen); ``f`` is always a python float."""
    lags = torch.arange(1, T + 1, dtype=dtype, device=device)
    if f == 0.0:
        vals = family.msd(lags, **p)
    else:
        # Savin-Doyle blur, same quadrature as physics.gp.imaging:
        # MSD_blur(t) = (2/f^2) int_0^f (f-u) {[MSD(t+u)+MSD(|t-u|)]/2
        #                                      - MSD(u)} du
        nodes, weights = np.polynomial.legendre.leggauss(_GL_POINTS)
        u = torch.as_tensor(f * 0.5 * (nodes + 1.0), dtype=dtype,
                            device=device)                          # (Q,)
        w = torch.as_tensor(f * 0.5 * weights, dtype=dtype, device=device) \
            * (2.0 / f**2) * (f - u)
        m_plus = family.msd(lags[:, None] + u[None, :], **p)
        m_minus = family.msd(torch.abs(lags[:, None] - u[None, :]), **p)
        m_u = family.msd(u, **p)[None, :]
        vals = torch.sum(w[None, :] * (0.5 * (m_plus + m_minus) - m_u), dim=1)
    vals = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                      vals + 2.0 * noise2])
    plateau = None
    if family.plateau is not None:
        plateau = family.plateau(**p) + 2.0 * noise2
    return vals, plateau


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _as_arrays(data):
    """(B, T, d) float, (B, T) bool numpy views of any accepted data form."""
    if isinstance(data, Trajectory):
        return (_host(data.data).astype(float)[None], _host(data.valid)[None])
    if hasattr(data, "data") and hasattr(data, "valid"):
        return _host(data.data).astype(float), _host(data.valid)
    from .parallel import stack_trajectories
    batch = stack_trajectories(list(data))
    return _host(batch.data).astype(float), _host(batch.valid)


def _normalize_spec(spec, fit_noise):
    """Validate the (nStates, d) spec of ``(family, params, mean,
    ss_order)`` entries; families given by name are resolved. With
    parameters tied across dims (the only mode), every dim of a state
    must carry the same family/params/ss_order (means may differ)."""
    units = []          # one per state: (family, params, noise2, f, ss)
    means = []          # (nStates, d)
    for s, state_entries in enumerate(spec):
        fams, ps, sss, ms = [], [], [], []
        for entry in state_entries:
            fam, params, mean, ss = entry
            if isinstance(fam, str):
                if fam not in _FAMILIES:
                    raise ValueError(f"unknown MSD family {fam!r}; have "
                                     f"{sorted(_FAMILIES)} (or pass an "
                                     "MSDFamily)")
                fam = _FAMILIES[fam]
            fams.append(fam)
            ps.append(dict(params))
            sss.append(int(ss))
            ms.append(float(mean))
        if any(f is not fams[0] or p != ps[0] or ss_ != sss[0]
               for f, p, ss_ in zip(fams, ps, sss)):
            raise ValueError(
                f"state {s}: parameters are tied across dims — every dim "
                "must carry the same (family, params, ss_order)")
        fam, params, ss = fams[0], ps[0], sss[0]
        if ss not in (0, 1):
            raise ValueError(f"ss_order should be 0 or 1; got {ss}")
        if ss == 0 and fam.plateau is None:
            raise ValueError(
                f"state {s}: family {fam.name!r} has no plateau (unbounded "
                "MSD) and cannot be positionally stationary (ss_order=0)")
        noise2 = float(params.pop("noise2", 0.0))
        f = float(params.pop("motion_blur_f", params.pop("f", 0.0)))
        missing = [k for k in fam.fields if k not in params]
        if missing:
            raise ValueError(f"state {s}: family {fam.name!r} needs "
                             f"parameters {fam.fields}; missing {missing}")
        extra = [k for k in params if k not in fam.fields]
        if extra:
            raise ValueError(f"state {s}: unknown parameters {extra} for "
                             f"family {fam.name!r}")
        if fit_noise and noise2 <= 0.0:
            raise ValueError(f"state {s}: fit_noise needs a positive "
                             f"starting noise2, got {noise2}")
        if any(params[k] <= 0 for k in fam.fields):
            raise ValueError(f"state {s}: parameters must be positive "
                             f"(log-space fit), got {params}")
        units.append((fam, params, noise2, f, ss))
        means.append(ms)
    return units, np.asarray(means, dtype=float)


def _extract_windows(profiles, ydata, valid, means, ss_orders):
    """Host extraction of per-(interval, dim) likelihood windows.

    Returns two stacked groups (possibly empty):
    ss0: (X, LAG, NF, U, COND) — padded centered values, |ti-tj| lag-index
         matrix, observed count, unit (state) index, conditioning flag;
    ss1: (Z, L00, L11, L01, L10, NI, U) — padded centered increments, the
         four lag-index matrices of the increment covariance, increment
         count, unit index.
    """
    B, T, d = ydata.shape
    w0, w1 = [], []
    for b in range(B):
        v = valid[b]
        if not v.any():
            continue
        Tb = T - int(np.argmax(v[::-1]))
        ivs = Loopingprofile(profiles[b, :Tb]).intervals()
        ivs[0] = (0, ivs[0][1], ivs[0][2])
        ivs[-1] = (ivs[-1][0], Tb, ivs[-1][2])
        for i, (t0, t1, s) in enumerate(ivs):
            t_start = t0 if i == 0 else t0 - 1
            frames = np.arange(t_start, t1)
            obs = frames[v[frames]]
            if len(obs) == 0:
                continue
            for dim in range(d):
                trace = ydata[b, obs, dim]
                if ss_orders[s] == 0:
                    x = trace - means[s, dim]
                    if i > 0:
                        # reference convention (reproduced by the
                        # interval table's "hybrid vector"): the
                        # conditioning value is the RAW
                        # first datum, not the centered one — the joint/
                        # marginal factorization then reproduces
                        # mu = trace[0] * C10/C00 exactly
                        x[0] = trace[0]
                    w0.append((x, obs, s, i > 0))
                elif len(obs) >= 2:
                    w1.append((np.diff(trace) - means[s, dim], obs, s))

    def pad(x, L):
        out = np.zeros(L)
        out[: len(x)] = x
        return out

    g0 = None
    if w0:
        L = max(len(x) for x, *_ in w0)
        lag = np.zeros((len(w0), L, L), dtype=np.int32)
        for j, (_, obs, _, _) in enumerate(w0):
            m = len(obs)
            lag[j, :m, :m] = np.abs(obs[:, None] - obs[None, :])
        g0 = (np.stack([pad(x, L) for x, *_ in w0]),
              lag,
              np.array([len(x) for x, *_ in w0], dtype=np.int32),
              np.array([s for _, _, s, _ in w0], dtype=np.int32),
              np.array([c for *_, c in w0], dtype=bool))
    g1 = None
    if w1:
        L = max(len(z) for z, *_ in w1)
        mats = np.zeros((4, len(w1), L, L), dtype=np.int32)
        for j, (_, obs, _) in enumerate(w1):
            ta, tb = obs[:-1], obs[1:]
            m = len(ta)
            mats[0, j, :m, :m] = np.abs(ta[:, None] - ta[None, :])
            mats[1, j, :m, :m] = np.abs(tb[:, None] - tb[None, :])
            mats[2, j, :m, :m] = np.abs(ta[:, None] - tb[None, :])
            mats[3, j, :m, :m] = np.abs(tb[:, None] - ta[None, :])
        g1 = (np.stack([pad(z, L) for z, *_ in w1]),
              mats[0], mats[1], mats[2], mats[3],
              np.array([len(z) for z, *_ in w1], dtype=np.int32),
              np.array([s for _, _, s in w1], dtype=np.int32))
    return g0, g1


def _gather_bins(idx, act, n_entries):
    """For `_LagGather`: ``(n_entries, widest bin)`` int64 positions into
    the flattened ``idx``, row e listing the ACTIVE positions that read
    table entry e, padded with ``idx.size`` (host numpy, made once per
    objective). Inactive positions (window padding) are left out: the
    identity mask of `_masked_logpdf` gives them a zero gradient."""
    pos = np.flatnonzero(act)
    key = idx.reshape(-1)[pos]
    order = np.argsort(key, kind="stable")
    pos, key = pos[order], key[order]
    counts = np.bincount(key, minlength=n_entries)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    bins = np.full((n_entries, max(int(counts.max(initial=0)), 1)), idx.size,
                   dtype=np.int64)
    bins[key, np.arange(len(key)) - starts[key]] = pos
    return bins


class _LagGather(torch.autograd.Function):
    """``table[idx]`` for a flat ``table`` and a static int64 ``idx`` that
    reads each entry many thousands of times (every window covariance is
    made of one state's ``T + 1`` lags). Autograd's own backward of such an
    index is a sorted serial accumulation per entry (84 of the 88 ms of one
    objective step at 64 trajectories of 100 frames on an H100); here each
    entry's gradient is one row sum of a gather through ``bins``
    (`_gather_bins`): no atomics, the same bits every time."""

    @staticmethod
    def forward(ctx, table, idx, bins):
        ctx.save_for_backward(bins)
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        (bins,) = ctx.saved_tensors
        padded = torch.cat([grad.reshape(-1), grad.new_zeros(1)])
        return padded[bins].sum(dim=1), None, None


def _active(n, L):
    """``(M, L, L)`` bool numpy: the leading ``n[m] x n[m]`` block of each
    padded window."""
    ii = np.arange(L)
    row = ii[None, :] < n[:, None]
    return row[:, :, None] & row[:, None, :]


def _masked_logpdf(x, C_raw, act, n):
    """``log N(x; 0, C)`` over the first ``n`` entries of each padded
    window: ``x (M, L)``, ``C_raw (M, L, L)``, ``act (M, L, L)`` bool (see
    `_active`), ``n (M,)``; inactive rows/cols of C are replaced by
    identity, inactive x is 0. One batched Cholesky without an error fetch
    (a failed factor gives NaN)."""
    eye = torch.eye(x.shape[-1], dtype=C_raw.dtype, device=x.device)
    C = torch.where(act, C_raw, eye)
    chol, info = torch.linalg.cholesky_ex(C, check_errors=False)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    # x' C^-1 x = |L^-1 x|^2: one triangular solve (a batched
    # `cholesky_solve` allocates inside the library and cannot be captured
    # into a CUDA graph)
    y = torch.linalg.solve_triangular(chol, x[..., None], upper=False)[..., 0]
    quad = (y * y).sum(-1)
    lp = -0.5 * (quad + logdet + n.to(x.dtype) * LOG_2PI)
    return torch.where(info == 0, lp, math.nan)


def make_ggm_nll(spec, data, profiles, fit_noise=False, *,
                 device=DEFAULT_DEVICE, dtype=torch.float32):
    """
    Build the differentiable GGM objective.

    Parameters
    ----------
    spec : (nStates, d) nested sequence of ``(family, params, mean,
        ss_order)``, the parametrized counterpart of
        `GenericGaussianModel`'s state_spec. ``family`` is ``"powerlaw"``
        (``G dt^a``), ``"twoLocusRouse"`` (`physics.rouse.two_locus_msd`),
        or a custom `MSDFamily`; ``params`` holds the family's starting
        parameters plus optional frozen ``noise2`` (localization,
        ``2*noise2`` per nonzero lag) and ``motion_blur_f``. Parameters
        are tied across dims (one set per state); means may differ per
        dim.
    data : Trajectory | TrajectoryBatch | sequence of Trajectory
    profiles : (T,) or (B, T) int array, or a ragged sequence of ``(T_b,)``
        profiles: the looping profile believed to underlie each trajectory.
    fit_noise : bool, additionally fit one ``noise2`` per state (log
        space; requires a positive start).
    device, dtype : where the objective runs (the GPU unless
        ``device="cpu"``) and its type.

    Returns
    -------
    nll : callable, negative mean per-observed-scalar log-likelihood of a
        ``params`` dict, a 0-dim tensor that autograd can differentiate;
        matches `GenericGaussianModel.logL_host` at the spec's own
        parameters.
    params0 : dict, ``{"s{n}": {"log_G": tensor, ...}}``.
    """
    device = resolve_device(device)
    ydata, valid = _as_arrays(data)
    B, T, d = ydata.shape
    units, means = _normalize_spec(spec, fit_noise)
    if len(means[0]) != d:
        raise ValueError(f"spec is for d={len(means[0])}, data has d={d}")

    # shares fit_rouse's coercion: (T,)/(B,T) broadcast, ragged lists (e.g.
    # sample_dataset(...).best_profile()) padded to T with state 0 on
    # invalid frames only (local import: fit.py imports this module)
    from .fit import _coerce_profiles
    profiles = np.asarray(_coerce_profiles(profiles, B, T, valid))
    if profiles.max() >= len(units):
        raise ValueError(f"profile state {profiles.max()} out of range for "
                         f"{len(units)} states")

    ss_orders = [u[4] for u in units]
    g0, g1 = _extract_windows(profiles, ydata, valid, means, ss_orders)
    n_obs = float(valid.sum() * d)

    def param(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    params0 = {}
    for s, (fam, p, noise2, f, ss) in enumerate(units):
        entry = {f"log_{k}": param(math.log(p[k])) for k in fam.fields}
        if fit_noise:
            entry["log_noise2"] = param(math.log(noise2))
        params0[f"s{s}"] = entry

    def dev(a):
        a = np.asarray(a)
        return torch.as_tensor(a, device=device).to(
            dtype if a.dtype == np.float64
            else torch.bool if a.dtype == bool else torch.int64)

    # per group: the flat table index ``unit * (T+1) + lag`` of every
    # covariance entry, the active blocks, and the backward's bins
    n_entries = len(units) * (T + 1)
    if g0 is not None:
        X, LAG, NF, U, COND = g0
        idx0 = U[:, None, None].astype(np.int64) * (T + 1) + LAG
        act0 = _active(NF, X.shape[1])
        bins0 = dev(_gather_bins(idx0, act0, n_entries))
        X, NF, U, COND, idx0, act0 = map(dev, (X, NF, U, COND, idx0, act0))
    if g1 is not None:
        Z, L00, L11, L01, L10, NI, U1 = g1
        idx1 = (U1[None, :, None, None].astype(np.int64) * (T + 1)
                + np.stack([L01, L10, L00, L11]))
        act1 = _active(NI, Z.shape[1])
        bins1 = dev(_gather_bins(idx1, np.broadcast_to(act1, idx1.shape),
                                 n_entries))
        Z, NI, idx1, act1 = map(dev, (Z, NI, idx1, act1))

    def nll(params):
        tabs, plats = [], []
        for s, (fam, p, noise2, f, ss) in enumerate(units):
            pj = {k: torch.exp(params[f"s{s}"][f"log_{k}"])
                  for k in fam.fields}
            n2 = (torch.exp(params[f"s{s}"]["log_noise2"]) if fit_noise
                  else noise2)
            tab, plat = _msd_table(fam, pj, n2, f, T, dtype, device)
            tabs.append(tab)
            plats.append(torch.zeros((), dtype=dtype, device=device)
                         if plat is None else plat)
        TAB = torch.stack(tabs)                                # (n, T+1)
        PLAT = torch.stack(plats)                              # (n,)

        total = torch.zeros((), dtype=dtype, device=device)
        if g0 is not None:
            C = 0.5 * (PLAT[U][:, None, None]
                       - _LagGather.apply(TAB.reshape(-1), idx0, bins0))
            lp = _masked_logpdf(X, C, act0, NF)
            # conditioning on the overlap frame = joint / marginal
            c00 = C[:, 0, 0]
            lp0 = -0.5 * (X[:, 0] ** 2 / c00 + torch.log(c00) + LOG_2PI)
            total = total + torch.sum(lp - torch.where(COND, lp0, 0.0))
        if g1 is not None:
            t01, t10, t00, t11 = _LagGather.apply(TAB.reshape(-1), idx1, bins1)
            C = 0.5 * (t01 + t10 - t00 - t11)
            total = total + torch.sum(_masked_logpdf(Z, C, act1, NI))
        return -total / n_obs

    return nll, params0


@dataclasses.dataclass
class GGMFitResult:
    """Outcome of `fit_ggm`. ``parameters[s]`` maps each state's fitted
    fields (plus ``noise2`` when fit) to their values."""
    parameters: list
    params: dict
    nll_trace: np.ndarray
    grad_norm: float
    model: object                      # re-built GenericGaussianModel

    @property
    def converged(self) -> bool:
        tail = max(2, len(self.nll_trace) // 10)
        a, b = self.nll_trace[-tail], self.nll_trace[-1]
        return bool(abs(a - b) <= 1e-6 * max(1.0, abs(b)))


def fit_ggm(spec, data, profiles, *, fit_noise=False, steps: int = 300,
            learning_rate: float = 0.05,
            model_kwargs: dict | None = None, device=DEFAULT_DEVICE,
            dtype=torch.float32) -> GGMFitResult:
    """
    Maximum-likelihood calibration of GGM state MSD parameters given
    trajectories and their looping profiles.

    See `make_ggm_nll` for the spec/argument contract. The optimization
    is `fit.fit_rouse`'s (log-space Adam; `bild_tpu.fit_ggm` also takes
    another optax optimizer, here it is always Adam); the result carries a
    ready `GenericGaussianModel` built at the fitted parameters on
    ``device`` in ``dtype`` (``model_kwargs`` forwards e.g.
    ``T_band``/``band_tol``).
    """
    from .fit import _run_adam

    nll, params0 = make_ggm_nll(spec, data, profiles, fit_noise=fit_noise,
                                device=device, dtype=dtype)
    # the Adam loop takes a flat dict of tensors
    flat0 = {f"{s}/{k}": v for s, entry in params0.items()
             for k, v in entry.items()}

    def nested(flat):
        out = {s: {} for s in params0}
        for name, v in flat.items():
            s, k = name.split("/")
            out[s][k] = v
        return out

    # on the GPU the loop replays the objective as one CUDA graph: every
    # operation of it, the batched Cholesky included, captures
    flat, trace, gnorm = _run_adam(lambda flat: nll(nested(flat)), flat0,
                                   steps, learning_rate)
    params = nested(flat)

    units, means = _normalize_spec(spec, fit_noise)
    parameters, new_spec = [], []
    for s, (fam, p, noise2, f, ss) in enumerate(units):
        fitted = {k: float(np.exp(params[f"s{s}"][f"log_{k}"]))
                  for k in fam.fields}
        n2 = (float(np.exp(params[f"s{s}"]["log_noise2"])) if fit_noise
              else noise2)
        parameters.append(dict(fitted, noise2=n2))
        msd_fun = fam.build(noise2=n2, f=f, **fitted)
        new_spec.append([(msd_fun, means[s, dim], ss)
                         for dim in range(means.shape[1])])

    from .models import GenericGaussianModel
    model = GenericGaussianModel(
        new_spec, **{"device": device, "dtype": dtype, **(model_kwargs or {})})
    return GGMFitResult(parameters=parameters, params=params,
                        nll_trace=trace, grad_norm=float(gnorm),
                        model=model)


def _spec_with_parameters(spec, parameters):
    """The spec updated to carry fitted per-state parameters (means,
    ss_order, family, and frozen blur preserved)."""
    out = []
    for s, state_entries in enumerate(spec):
        new_entries = []
        for entry in state_entries:
            fam, params, mean, ss = entry
            family = _FAMILIES[fam] if isinstance(fam, str) else fam
            p = {k: parameters[s][k] for k in family.fields}
            p["noise2"] = parameters[s]["noise2"]
            f = dict(params).get("motion_blur_f", dict(params).get("f", 0.0))
            if f:
                p["motion_blur_f"] = f
            new_entries.append((fam, p, mean, ss))
        out.append(new_entries)
    return out


@dataclasses.dataclass
class GGMCalibrationResult:
    """Outcome of `calibrate_ggm`: final model, last inference results
    (BatchResults / DatasetResults), per-round fit history, final MAP
    profiles ((B, T) array for engine="batch", ragged list for
    engine="dataset")."""
    model: object
    results: object
    fits: list
    profiles: object

    @property
    def parameters(self):
        return self.fits[-1].parameters


def calibrate_ggm(spec, data, *, rounds: int = 2, engine: str = "batch",
                  sample_kwargs: dict | None = None,
                  fit_kwargs: dict | None = None,
                  model_kwargs: dict | None = None,
                  generator: torch.Generator | None = None,
                  device=DEFAULT_DEVICE,
                  dtype=torch.float32) -> GGMCalibrationResult:
    """
    Joint profile inference + GGM MSD-parameter calibration by hard-EM
    alternation (the GGM counterpart of `fit.calibrate_rouse`): each round
    runs lockstep inference (`parallel.sample_batch`) with the current
    parameters and refits each state's MSD on the frames its MAP profiles
    assign to it (`fit_ggm`).

    Unlike `calibrate_rouse` there is NO neutral (constant-profile) init:
    GGM states have INDEPENDENT parameters, so a constant-state-0 fit
    would update state 0 only and leave the others at their starting
    values. Start each state within its basin (e.g. from a
    full-trajectory MSD fit, or separate fits on hand-labeled segments).

    ``engine="dataset"`` runs the E-step through `parallel.sample_dataset`
    instead of one lockstep `parallel.sample_batch` (ragged length
    bucketing, fixed-size chunks, per-chunk checkpointing via its
    ``sample_kwargs``); it requires a Trajectory sequence. ``generator`` (a
    `torch.Generator`, default seeded 0) seeds the inference passes, one
    generator spawned from it per round. ``device``, ``dtype``: where the
    models and the objective live.
    """
    from .models import GenericGaussianModel
    from .parallel import sample_batch, sample_dataset, stack_trajectories

    if engine not in ("batch", "dataset"):
        raise ValueError(f"engine must be 'batch' or 'dataset', got "
                         f"{engine!r}")
    if isinstance(data, Trajectory):
        data = [data]
    if hasattr(data, "data") and hasattr(data, "valid"):
        if engine == "dataset":
            raise ValueError("engine='dataset' needs a Trajectory "
                             "sequence (it buckets ragged lengths itself)")
        trajs, batch = None, data
    else:
        trajs = list(data)
        batch = None if engine == "dataset" else stack_trajectories(trajs)
    fit_data = trajs if engine == "dataset" else batch
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    sample_kwargs = dict(sample_kwargs or {})
    fit_kwargs = dict(fit_kwargs or {})
    model_kwargs = {"device": device, "dtype": dtype, **(model_kwargs or {})}
    units, means = _normalize_spec(spec, fit_kwargs.get("fit_noise", False))
    model = GenericGaussianModel(
        [[(fam.build(noise2=noise2, f=f, **p), means[s, dim], ss)
          for dim in range(means.shape[1])]
         for s, (fam, p, noise2, f, ss) in enumerate(units)],
        **model_kwargs)

    fits, res, profiles = [], None, None
    cur_spec = spec
    for _ in range(rounds):
        sub = spawn_generator(generator)
        if engine == "dataset":
            res = sample_dataset(model, trajs, generator=sub, **sample_kwargs)
            profiles = res.best_profile()            # ragged list
        else:
            res = sample_batch(model, batch, generator=sub, **sample_kwargs)
            profiles = np.asarray(res.best_profile())
        fit = fit_ggm(cur_spec, fit_data, profiles, device=device,
                      dtype=dtype, model_kwargs=model_kwargs, **fit_kwargs)
        fits.append(fit)
        model = fit.model
        cur_spec = _spec_with_parameters(cur_spec, fit.parameters)

    return GGMCalibrationResult(model=model, results=res, fits=fits,
                                profiles=profiles)
