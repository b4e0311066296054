"""
Downstream statistics for inferred profiles (a copy of `bild_tpu.stats`:
host numpy and scipy, no framework).

Reference parity: ``bild/stats.py`` (Kaplan-Meier survival on right-censored
dwell times; censored-exponential MLE with exact confidence bounds). Host
numpy/scipy: these post-process small host-side summaries.
"""
from __future__ import annotations

import numpy as np
from scipy import optimize, stats

__all__ = ["dwell_times", "KM_survival", "MLE_censored_exponential"]


def dwell_times(profiles, state, dt=1.0):
    """
    Censored dwell-time sample of one state from inferred looping profiles.

    The bridge from inference output to the survival estimators below:
    extracts every constant-``state`` interval from each profile and marks
    the intervals touching either end of the observation window as
    right-censored (their true dwell time is only bounded below — the same
    open-ended intervals the reference returns with ``None`` bounds,
    ``bild/util.py:89-108``; the reference leaves this extraction to the
    user, its estimators consume exactly this ``(data, censored)`` pair).

    Durations count propagation steps times ``dt``: frame ``t`` is reached
    by one step governed by ``profile[t]`` (``bild/util.py:10-24``), so an
    interior interval over frames ``[a, b)`` lasted ``(b - a) * dt``. In the
    first interval ``profile[0]`` selects the steady state rather than a
    step, so its observed duration is ``(b - 1) * dt``; a first interval
    covering only frame 0 has zero observed duration and is dropped (a
    vacuous ``t_true > 0`` bound).

    Parameters
    ----------
    profiles : (B, T) or (T,) int array, Loopingprofile, or sequence of
        1-d profiles (ragged ok — e.g. ``DatasetResults.best_profile()``)
    state : int
        the state whose dwell times to collect
    dt : float, optional
        frame interval in physical time units

    Returns
    -------
    durations : (M,) float array
    censored : (M,) bool array
        ready for `KM_survival` / `MLE_censored_exponential`
    """
    if isinstance(profiles, (list, tuple)) and len(profiles) \
            and np.ndim(profiles[0]) >= 1:
        rows = [np.asarray(p, dtype=int).ravel() for p in profiles]
    else:
        arr = np.asarray(profiles)
        if arr.dtype == object:
            rows = [np.asarray(p, dtype=int).ravel() for p in arr]
        elif arr.ndim <= 1:
            rows = [arr.astype(int).ravel()]
        else:
            rows = list(arr.astype(int))

    durations, censored = [], []
    for s in rows:
        T = len(s)
        if T == 0:
            continue
        cuts = np.flatnonzero(s[1:] != s[:-1]) + 1
        starts = np.concatenate([[0], cuts])
        ends = np.concatenate([cuts, [T]])
        for a, b in zip(starts, ends):
            if s[a] != state:
                continue
            first, last = a == 0, b == T
            dur = (b - a - (1 if first else 0)) * dt
            if dur <= 0:
                continue
            durations.append(dur)
            censored.append(first or last)
    return np.asarray(durations, dtype=float), np.asarray(censored, dtype=bool)


def KM_survival(data, censored, conf=0.95, Tmax=np.inf, S1at=0):
    """
    Kaplan-Meier survival estimator with Greenwood log-log confidence bands
    (reference ``bild/stats.py:7-65``), fully vectorized: event/at-risk
    counts via searchsorted on the sorted sample, survival via cumprod,
    Greenwood variance via cumsum.

    Returns ``(T, 4)`` array with columns ``t, S(t), lower(t), upper(t)``
    (column convention matches the reference: with ``z < 0`` column 2 is the
    numerically-upper band).
    """
    data = np.asarray(data, dtype=float)
    censored = np.asarray(censored).astype(bool)

    event_times = np.unique(data[~censored])
    event_times = event_times[event_times <= Tmax]

    # events at each time / individuals still at risk, all vectorized
    sorted_events = np.sort(data[~censored])
    sorted_all = np.sort(data)
    d = (np.searchsorted(sorted_events, event_times, side="right")
         - np.searchsorted(sorted_events, event_times, side="left"))
    n_at_risk = len(sorted_all) - np.searchsorted(sorted_all, event_times, side="left")

    frac = 1.0 - d / n_at_risk
    S = np.concatenate([[1.0], np.cumprod(frac)])

    # Greenwood variance of log(-log S); saturated steps (all at-risk die)
    # poison the running sum from that point on, matching the sequential
    # reference semantics
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(n_at_risk > d, d / (n_at_risk * (n_at_risk - d)), np.inf)
        greenwood = np.cumsum(terms)
        V = np.concatenate([[0.0], np.log(S[1:]) ** (-2) * greenwood])
        V[~np.isfinite(V)] = 0.0

        z = stats.norm().ppf((1 - conf) / 2)
        band_lo = S ** (np.exp(z * np.sqrt(V)))
        band_hi = S ** (np.exp(-z * np.sqrt(V)))

    if S1at is not None:
        t_out = np.concatenate([[S1at], event_times])
    else:
        t_out = event_times
        S, band_lo, band_hi = S[1:], band_lo[1:], band_hi[1:]

    return np.stack([t_out, S, band_lo, band_hi], axis=-1)


def MLE_censored_exponential(data, censored, conf=0.95):
    """
    Maximum-likelihood mean of an exponential distribution from
    right-censored data, with a profile-likelihood confidence interval
    (same estimator and interval definition as reference
    ``bild/stats.py:67-110``). Returns ``(m, low, high)``.

    Derivation: with ``S = sum(data)`` and ``n`` fully-observed events, the
    censored-exponential log-likelihood is ``-n log m - S/m``, maximized at
    ``m* = S/n``. The interval is the set of m whose log-likelihood lies
    within half a chi-square(1) quantile of the maximum; the gap is
    ``n * (m*/m - 1 + log(m/m*))``, which is 0 at ``m*`` and increases
    monotonically in both directions, so each endpoint is a simple
    bracketed root.
    """
    data = np.asarray(data, dtype=float).ravel()
    censored = np.asarray(censored, dtype=bool).ravel()

    n = np.count_nonzero(~censored)
    mle = np.sum(data) / n
    half_q = stats.chi2(1).isf(1 - conf) / 2

    def gap(m):
        return n * (mle / m - 1 + np.log(m / mle)) - half_q

    def endpoint(factor):
        # geometric search away from the MLE until the gap turns positive,
        # then polish with brentq on the enclosing bracket
        outer = mle * factor
        for _ in range(200):
            if gap(outer) > 0:
                break
            outer *= factor
        else:  # pragma: no cover
            raise RuntimeError("Could not bracket the confidence bound")
        inner = outer / factor
        return optimize.brentq(gap, *sorted((inner, outer)))

    return mle, endpoint(0.5), endpoint(2.0)
