"""
Batched multi-state Kalman likelihood in plain PyTorch (counterpart of
`bild_tpu.ops.kalman`).

The unit of work is a batch of P profiles of one trajectory, marched
together through a Python loop over frames (the JAX package's
``lax.scan``). Each profile gathers its own state's propagator per frame;
out-of-range states are clamped for the gather and the profile's result
is NaN. The covariance carries ``q = d*`` copies, one per distinct
localization error, with ``Cind`` mapping each dimension to its copy.

This is the ``'torch'`` selector, the CPU path of the models, and the
plain version of the dense CUDA kernel (`ops.kalman_dense`).
"""
from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)

__all__ = ["msrouse_logL_batch", "kalman_update_batch", "in_range_mask"]


def in_range_mask(profiles: torch.Tensor, n: int) -> torch.Tensor:
    """``(P,)`` True where every state of the profile lies in ``[0, n)``."""
    return ((profiles >= 0) & (profiles < n)).all(dim=1)


def kalman_update_batch(M, C, y, w, s2, Cind):
    """
    Batched Kalman measurement update.

    ``M (P, N, d)`` prior means, ``C (P, q, N, N)`` prior covariances,
    ``y (d,)`` observation, ``w (N,)`` measurement vector, ``s2 (q,)``
    squared localization errors, ``Cind (d,)`` long map d -> q. Returns the
    posterior ``M, C`` and the ``(P,)`` observation log-likelihood.
    """
    Cw = torch.einsum("pqij,j->pqi", C, w)                 # (P, q, N)
    S = torch.einsum("pqi,i->pq", Cw, w) + s2              # (P, q)
    K = Cw / S[..., None]                                  # (P, q, N)
    C_new = C - K[..., :, None] * Cw[..., None, :]         # (P, q, N, N)

    m = torch.einsum("pid,i->pd", M, w)                    # (P, d)
    xmm = y[None, :] - m                                   # (P, d)
    Kd = K[:, Cind]                                        # (P, d, N)
    M_new = M + Kd.transpose(1, 2) * xmm[:, None, :]       # (P, N, d)

    Sd = S[:, Cind]                                        # (P, d)
    logl = -0.5 * (xmm * xmm / Sd + torch.log(Sd) + LOG_2PI)
    return M_new, C_new, logl.sum(dim=1)


def logL_dense_loop(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata,
                    valid, symmetrize):
    """The dense-covariance recursion shared by `msrouse_logL_batch` and
    `ops.kalman_dense.msrouse_logL_dense_torch` (see the module docstring).
    Propagation is ``C' = (B C) B + Sig``, ``M' = B M + G``."""
    P, T = profiles.shape
    n = Bs.shape[0]
    q = s2.shape[0]
    Cind = torch.as_tensor(Cind, dtype=torch.long, device=ydata.device)
    prof = profiles.long().clamp(0, n - 1)
    valid_host = valid.tolist()           # one host read, not one per frame

    st0 = prof[:, 0]
    M = M0s[st0]                                           # (P, N, d)
    C = C0s[st0][:, None].expand(P, q, *C0s.shape[1:])     # (P, q, N, N)
    acc = torch.zeros((P,), dtype=ydata.dtype, device=ydata.device)

    if valid_host[0]:
        M, C, ll = kalman_update_batch(M, C, ydata[0], w, s2, Cind)
        acc = acc + ll

    for t in range(1, T):
        st = prof[:, t]
        B = Bs[st]                                         # (P, N, N)
        M = torch.bmm(B, M) + Gs[st]
        X = torch.einsum("pij,pqjk->pqik", B, C)
        C = torch.einsum("pqik,pkj->pqij", X, B) + Sigs[st][:, None]
        if symmetrize:
            C = 0.5 * (C + C.transpose(-1, -2))
        if valid_host[t]:
            M, C, ll = kalman_update_batch(M, C, ydata[t], w, s2, Cind)
            acc = acc + ll

    return torch.where(in_range_mask(profiles, n), acc,
                       torch.full_like(acc, math.nan))


def msrouse_logL_batch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                       profiles, ydata, valid, symmetrize=True):
    """
    ``(P,)`` log-likelihoods of a batch of profiles for one trajectory.

    ``Bs, Sigs, C0s (n, N, N)``, ``Gs, M0s (n, N, d)``, ``w (N,)``,
    ``s2 (q,)``, ``Cind (d,)``, ``profiles (P, T)`` int, ``ydata (T, d)``
    (zeros at missing frames), ``valid (T,)`` bool. The initial condition is
    selected by ``profiles[:, 0]``; ``symmetrize`` re-symmetrizes the
    covariance each frame. Out-of-range states give NaN.
    """
    msrouse_logL_batch.calls += 1
    return logL_dense_loop(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,
                           ydata, valid, symmetrize)


msrouse_logL_batch.calls = 0
