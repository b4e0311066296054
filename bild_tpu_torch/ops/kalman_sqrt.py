"""
Square-root (factor) form of the Rouse-Kalman likelihood (counterpart of
`bild_tpu.ops.kalman_sqrt`).

The standard filter (`ops.kalman`) propagates the covariance ``C`` and
subtracts a rank-one term at every observation. This one carries a factor
``L`` with ``C = L L^T`` instead, and never subtracts:

- propagation ``C' = B C B^T + Sig`` is an LQ re-triangularization of the
  ``N x 2N`` pre-array ``[B L | L_Sig]``;
- the measurement update is an LQ of the ``(N+1) x (N+1)`` pre-array

      [ sqrt(s2)  w^T L ]          [ sqrt(S)        0  ]
      [    0        L   ]   ->     [ Cw/sqrt(S)     L' ]

  which gives the innovation variance ``S``, the gain and the downdated
  factor ``L'`` in one orthogonal transform.

It costs two batched QR factorizations per frame, so it is an instrument,
not a production path: run in float32 beside its float64 run, it shows how
far the float32 drift of the standard filter comes from the covariance
recursion. Interface and semantics are those of `ops.kalman`'s single-lane
form.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import full_fp32
from .kalman import in_range_mask

LOG_2PI = math.log(2.0 * math.pi)

__all__ = ["msrouse_logL_sqrt", "psd_factor"]

# float64 factors of the per-state noise and steady-state covariances, on
# the device, keyed by content, dtype and device
_SQRT_OPS_CACHE = {}
_SQRT_OPS_CACHE_MAX = 16


def psd_factor(C):
    """``L`` with ``L @ L.T = C`` for each PSD matrix of ``C (..., N, N)``
    (numpy, computed in float64). eigh rather than Cholesky: the Rouse
    steady state pins free modes to zero variance, so the matrices are
    PSD, not PD. The LQ steps below accept any factor."""
    lam, V = np.linalg.eigh(np.asarray(C, dtype=np.float64))
    return V * np.sqrt(np.clip(lam, 0.0, None))[..., None, :]


def _sqrt_operators(Sigs, C0s):
    """``(LSigs, L0s)`` in ``Sigs``' dtype and on its device."""
    key = (Sigs.cpu().numpy().tobytes(), C0s.cpu().numpy().tobytes(),
           Sigs.dtype, Sigs.device)
    hit = _SQRT_OPS_CACHE.pop(key, None)
    if hit is None:
        while len(_SQRT_OPS_CACHE) >= _SQRT_OPS_CACHE_MAX:
            _SQRT_OPS_CACHE.pop(next(iter(_SQRT_OPS_CACHE)))
        hit = tuple(torch.as_tensor(psd_factor(x.cpu().numpy()),
                                    dtype=Sigs.dtype, device=Sigs.device)
                    for x in (Sigs, C0s))
    _SQRT_OPS_CACHE[key] = hit
    return hit


def _lq(A):
    """Lower-triangular ``L`` with ``L L^T = A A^T`` for each matrix of
    ``A (..., m, n)``, m <= n: the LQ step, as the QR of the transpose. The
    signs of L's columns are those the QR gives; only ``L L^T`` enters."""
    return torch.linalg.qr(A.mT, mode="r")[1].mT


def _update(M, Ls, y, w, sroot, Cind):
    """Measurement update of ``M (P, N, d)`` and ``Ls (P, q, N, N)`` by the
    observation ``y (d,)``: the posterior and the ``(P,)`` log-density.
    ``S = post[0,0]^2`` and ``K = post[1:,0] / post[0,0]`` do not depend on
    the sign of the QR's first column."""
    P, q, N, _ = Ls.shape
    top = torch.cat([sroot.expand(P, q)[..., None, None],
                     torch.einsum("i,pqij->pqj", w, Ls)[..., None, :]], dim=-1)
    bottom = torch.cat([Ls.new_zeros(P, q, N, 1), Ls], dim=-1)
    post = _lq(torch.cat([top, bottom], dim=-2))           # (P, q, N+1, N+1)
    S = post[..., 0, 0] ** 2                               # (P, q)
    K = post[..., 1:, 0] / post[..., :1, 0]                # (P, q, N)
    xmm = y - torch.einsum("pid,i->pd", M, w)              # (P, d)
    Sd = S[:, Cind]                                        # (P, d)
    M_new = M + K[:, Cind].transpose(1, 2) * xmm[:, None, :]
    ll = -0.5 * (xmm * xmm / Sd + torch.log(Sd) + LOG_2PI).sum(dim=1)
    return M_new, post[..., 1:, 1:], ll


def msrouse_logL_sqrt(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                      profiles, ydata, valid):
    """
    ``(P,)`` log-likelihoods of ``profiles (P, T)`` in the square-root form,
    with the arguments of `ops.kalman.msrouse_logL_batch`'s single-lane
    form: ``Bs, Sigs, C0s (n, N, N)``, ``Gs, M0s (n, N, d)``, ``w (N,)``,
    ``s2 (q,)`` the distinct squared localization errors, ``Cind (d,)``
    each dimension's index among them, ``ydata (T, d)`` (zeros at missing
    frames), ``valid (T,)``. Computes in ``ydata``'s dtype on its device,
    matrix products in full float32 (`config.full_fp32`); the factors of
    ``Sigs`` and ``C0s`` are made on the host in float64 and cached by
    content. Out-of-range states give NaN.
    """
    with full_fp32():
        return _sqrt_body(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,
                          ydata, valid)


def _sqrt_body(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata, valid):
    LSigs, L0s = _sqrt_operators(Sigs, C0s)
    n = Bs.shape[0]
    q = s2.shape[0]
    dev = ydata.device
    Cind = torch.as_tensor(Cind, dtype=torch.long, device=dev)
    sroot = torch.sqrt(s2)
    P, T = profiles.shape
    prof = profiles.long().clamp(0, n - 1)

    def observe(t, M, Ls, acc):
        M_u, Ls_u, ll = _update(M, Ls, ydata[t], w, sroot, Cind)
        v = valid[t]
        return (torch.where(v, M_u, M), torch.where(v, Ls_u, Ls),
                acc + torch.where(v, ll, 0.0))

    st0 = prof[:, 0]
    M = M0s[st0]                                           # (P, N, d)
    Ls = L0s[st0][:, None].expand(P, q, *L0s.shape[1:])    # (P, q, N, N)
    acc = torch.zeros((P,), dtype=ydata.dtype, device=dev)
    M, Ls, acc = observe(0, M, Ls, acc)
    for t in range(1, T):
        st = prof[:, t]
        B = Bs[st]                                         # (P, N, N)
        M = torch.bmm(B, M) + Gs[st]
        pre = torch.cat([torch.einsum("pij,pqjk->pqik", B, Ls),
                         LSigs[st][:, None].expand(P, q, *LSigs.shape[1:])],
                        dim=-1)                            # (P, q, N, 2N)
        Ls = _lq(pre)
        M, Ls, acc = observe(t, M, Ls, acc)
    return torch.where(in_range_mask(profiles, n), acc,
                       torch.full_like(acc, math.nan))
