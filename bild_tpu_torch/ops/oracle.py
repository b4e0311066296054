"""
NumPy float64 oracle for the multi-state Rouse Kalman likelihood.

This is a sequential, single-profile transcription of the *algorithm* of the
reference kernel (``bild/src/MSRouse_logL.pyx:95-256`` and its pure-python
drop-in ``bild/src/MSRouse_logL_py.py``): mean/covariance propagation through
per-frame state-selected linear-Gaussian dynamics, with a Kalman update at
every observed frame and the d*-deduplication of covariance propagation
across spatial dimensions sharing a localization error.

A copy of `bild_tpu.ops.oracle` (numpy only), so that the port can hold
its CUDA kernels to it on a machine without JAX (``chip_smoke.py``).
"""
from __future__ import annotations

import numpy as np

LOG_2PI = float(np.log(2.0 * np.pi))

__all__ = ["msrouse_logL_numpy"]


def msrouse_logL_numpy(Bs, Gs, Sigs, M0s, C0s, w, localization_error, profile, trajdata):
    """
    Parameters
    ----------
    Bs, Sigs : (n, N, N) float64
        per-state propagator and one-step noise covariance
    Gs : (n, N, d) float64
        per-state additive drift
    M0s : (n, N, d), C0s : (n, N, N) float64
        per-state steady-state mean / covariance
    w : (N,) measurement vector
    localization_error : (d,) noise std per spatial dimension
    profile : (T,) int state sequence; ``profile[0]`` selects the initial
        steady state (reference semantics, ``bild/util.py:10-24``)
    trajdata : (T, d) float64 with NaN rows marking missing frames

    Returns
    -------
    float
    """
    Bs = np.asarray(Bs, dtype=np.float64)
    Gs = np.asarray(Gs, dtype=np.float64)
    Sigs = np.asarray(Sigs, dtype=np.float64)
    profile = np.asarray(profile, dtype=int)
    trajdata = np.asarray(trajdata, dtype=np.float64)
    T, d = trajdata.shape

    unique_errors, Cind = np.unique(np.asarray(localization_error, dtype=np.float64),
                                    return_inverse=True)
    s2 = unique_errors**2
    dstar = len(unique_errors)

    M = np.array(M0s[profile[0]], dtype=np.float64, copy=True)       # (N, d)
    C = np.tile(np.asarray(C0s[profile[0]], dtype=np.float64), (dstar, 1, 1))

    observed = ~np.any(np.isnan(trajdata), axis=1)
    total = 0.0

    def update(M, C, x):
        Cw = C @ w                                # (dstar, N)
        S = Cw @ w + s2                           # (dstar,)
        K = Cw / S[:, None]                       # (dstar, N)
        C = C - K[:, :, None] * Cw[:, None, :]    # (dstar, N, N)
        xmm = x - w @ M                           # (d,)
        M = M + K[Cind].T * xmm[None, :]          # (N, d)
        logl = -0.5 * (xmm * xmm / S[Cind] + np.log(S)[Cind] + LOG_2PI)
        return M, C, float(np.sum(logl))

    if observed[0]:
        M, C, ll = update(M, C, trajdata[0])
        total += ll

    for t in range(1, T):
        s = profile[t]
        M = Bs[s] @ M + Gs[s]
        C = Bs[s] @ C @ Bs[s] + Sigs[s][None, :, :]
        if observed[t]:
            M, C, ll = update(M, C, trajdata[t])
            total += ll

    return total
