"""
MSD <-> Gaussian-process covariance machinery (counterpart of
`bild_tpu.physics.gp`; the package keeps its own copy).

- `MSDfun`: decorator normalizing an MSD callable (array input, ``|dt|``,
  ``MSD(0) = 0``).
- `imaging(noise2, f, alpha0)`: decorator adding localization noise and
  motion blur with exposure fraction ``f`` to an MSD. The blur correction is
  the standard exposure-average (Savin-Doyle) double integral, reduced to a
  single weighted integral and evaluated by Gauss-Legendre quadrature:

      MSD_blur(t) = (2/f^2) int_0^f (f-u) { [MSD(t+u)+MSD(|t-u|)]/2 - MSD(u) } du

  For ``f = 0`` this is the identity.
- `msd2C`: build a covariance matrix from an MSD function for sampling times
  ``ti``, for steady-state order 0 (positionally stationary: covariance from
  the MSD plateau) or 1 (increment-stationary: covariance of increments).

These are host functions (numpy): the `GenericGaussianModel` evaluates its
MSD callables only at integer lags and at infinity, and moves those lag
tables to its device; the dense linear algebra on them runs there.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["MSDfun", "imaging", "msd2C", "msd2C_fun"]

_GL_POINTS = 32


def MSDfun(fun):
    """
    Decorator for MSD functions (parity with ``bayesmsd.deco.MSDfun``):
    vectorizes over ``dt``, takes ``|dt|``, and pins ``MSD(0) = 0``.
    """

    @functools.wraps(fun)
    def wrapper(dt, **kwargs):
        dt = np.abs(np.asarray(dt, dtype=float))
        scalar = dt.ndim == 0
        dt = np.atleast_1d(dt)
        out = np.zeros_like(dt)
        nz = dt > 0
        if np.any(nz):
            out[nz] = fun(dt[nz], **kwargs)
        return out[0] if scalar else out

    return wrapper


def imaging(noise2=0.0, f=0.0, alpha0=1.0):
    """
    Decorator factory adding imaging artifacts to an MSD function (parity with
    ``bayesmsd.deco.imaging``): localization noise ``2*noise2`` on every
    nonzero lag and motion blur for exposure fraction ``f`` of the frame
    interval. ``alpha0`` is the short-time scaling exponent of the underlying
    MSD; it is used to extend the blur integrand continuously to ``t = 0``.
    """
    if not 0 <= f <= 1:
        raise ValueError(f"exposure fraction f should be in [0, 1]; got {f}")

    # Gauss-Legendre nodes/weights on [0, 1], reused for every call
    nodes, weights = np.polynomial.legendre.leggauss(_GL_POINTS)
    nodes = 0.5 * (nodes + 1.0)
    weights = 0.5 * weights

    def decorator(msdfun):
        @functools.wraps(msdfun)
        def wrapper(dt, **kwargs):
            dt = np.abs(np.asarray(dt, dtype=float))
            scalar = dt.ndim == 0
            dt = np.atleast_1d(dt)
            out = np.zeros_like(dt)

            isinf = np.isinf(dt)
            out[isinf] = msdfun(np.array([np.inf]), **kwargs)[0] + 2 * noise2

            nz = (dt > 0) & ~isinf
            if np.any(nz):
                t = dt[nz]
                if f == 0:
                    blurred = msdfun(t, **kwargs)
                else:
                    u = f * nodes  # (Q,)
                    w = f * weights * 2.0 / f**2 * (f - u)  # quadrature x (2/f^2)(f-u)
                    # integrand pieces, vectorized over (T, Q)
                    m_plus = msdfun(np.abs(t[:, None] + u[None, :]).ravel(), **kwargs).reshape(len(t), -1)
                    m_minus = msdfun(np.abs(t[:, None] - u[None, :]).ravel(), **kwargs).reshape(len(t), -1)
                    m_u = msdfun(u, **kwargs)[None, :]
                    blurred = np.sum(w[None, :] * (0.5 * (m_plus + m_minus) - m_u), axis=1)
                out[nz] = blurred + 2 * noise2

            return out[0] if scalar else out

        return wrapper

    return decorator


def msd2C(msd_fun, ti, ss_order):
    """
    Covariance matrix from an MSD function (parity with
    ``bayesmsd.gp.msd2C_fun``).

    Parameters
    ----------
    msd_fun : callable
        vectorized MSD function (output of `MSDfun`/`imaging`).
    ti : (n,) array of sampling times
    ss_order : {0, 1}
        0: positionally stationary; returns the ``(n, n)`` covariance of the
        positions, ``C_ij = (MSD(inf) - MSD(|t_i - t_j|)) / 2``.
        1: increment-stationary; returns the ``(n-1, n-1)`` covariance of the
        increments ``x(t_{i+1}) - x(t_i)``.
    """
    ti = np.asarray(ti, dtype=float)
    if ss_order == 0:
        plateau = float(msd_fun(np.inf))
        return 0.5 * (plateau - msd_fun(np.abs(ti[:, None] - ti[None, :])))
    elif ss_order == 1:
        t0, t1 = ti[:-1], ti[1:]
        return 0.5 * (
            msd_fun(np.abs(t0[:, None] - t1[None, :]))
            + msd_fun(np.abs(t1[:, None] - t0[None, :]))
            - msd_fun(np.abs(t0[:, None] - t0[None, :]))
            - msd_fun(np.abs(t1[:, None] - t1[None, :]))
        )
    else:
        raise ValueError(f"ss_order should be 0 or 1; got {ss_order}")


# name alias for drop-in parity with ``bayesmsd.gp.msd2C_fun``
msd2C_fun = msd2C
