"""
Batched multi-state Kalman likelihood in plain PyTorch (counterpart of
`bild_tpu.ops.kalman`).

The unit of work is a batch of P profiles for each of L lanes (a lane is
one trajectory), marched together through a Python loop over frames (the
JAX package's ``lax.scan``, vmapped over trajectories). Each profile
gathers its own state's propagator per frame; out-of-range states are
clamped for the gather and the profile's result is NaN. The covariance
carries ``q = d*`` copies, one per distinct localization error, with
``Cind`` mapping each dimension to its copy. Missing frames differ per
lane, so the measurement update is applied everywhere and kept only where
the lane's frame is observed.

This is the ``'torch'`` selector, the CPU path of the models, and the
plain version of the dense CUDA kernel (`ops.kalman_dense`).
"""
from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)

__all__ = ["msrouse_logL_batch", "kalman_update_batch", "in_range_mask",
           "as_lanes"]


def in_range_mask(profiles: torch.Tensor, n: int) -> torch.Tensor:
    """``(..., P)`` True where every state of the profile lies in ``[0, n)``."""
    return ((profiles >= 0) & (profiles < n)).all(dim=-1)


def as_lanes(profiles, ydata, valid):
    """The lane form of a likelihood call: ``profiles (L, P, T)``, ``ydata
    (L, T, d)``, ``valid (L, T)``, and whether the call was the single-lane
    form ``(P, T)``, ``(T, d)``, ``(T,)`` (its result then drops the lane
    axis). Raises on any other combination of shapes."""
    single = profiles.dim() == 2
    if single:
        profiles, ydata, valid = profiles[None], ydata[None], valid[None]
    if profiles.dim() != 3 or ydata.dim() != 3 or valid.dim() != 2:
        raise ValueError(
            "expected profiles (P, T), ydata (T, d), valid (T,) or profiles "
            "(L, P, T), ydata (L, T, d), valid (L, T); got "
            f"{tuple(profiles.shape)}, {tuple(ydata.shape)}, {tuple(valid.shape)}")
    L, _, T = profiles.shape
    if ydata.shape[:2] != (L, T) or valid.shape != (L, T):
        raise ValueError(
            f"profiles {tuple(profiles.shape)} do not match ydata "
            f"{tuple(ydata.shape)} and valid {tuple(valid.shape)}")
    return profiles, ydata, valid, single


def kalman_update_batch(M, C, y, w, s2, Cind):
    """
    Batched Kalman measurement update.

    ``M (P, N, d)`` prior means, ``C (P, q, N, N)`` prior covariances,
    ``y`` the observation, ``(d,)`` or one per profile ``(P, d)``, ``w
    (N,)`` measurement vector, ``s2 (q,)`` squared localization errors,
    ``Cind (d,)`` long map d -> q. Returns the posterior ``M, C`` and the
    ``(P,)`` observation log-likelihood.
    """
    Cw = torch.einsum("pqij,j->pqi", C, w)                 # (P, q, N)
    S = torch.einsum("pqi,i->pq", Cw, w) + s2              # (P, q)
    K = Cw / S[..., None]                                  # (P, q, N)
    C_new = C - K[..., :, None] * Cw[..., None, :]         # (P, q, N, N)

    m = torch.einsum("pid,i->pd", M, w)                    # (P, d)
    xmm = y - m                                            # (P, d)
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
    profiles, ydata, valid, single = as_lanes(profiles, ydata, valid)
    L, P, T = profiles.shape
    n = Bs.shape[0]
    q = s2.shape[0]
    dev = ydata.device
    Cind = torch.as_tensor(Cind, dtype=torch.long, device=dev)
    prof = profiles.reshape(L * P, T).long().clamp(0, n - 1)
    lane = torch.arange(L * P, device=dev) // P            # row -> lane

    st0 = prof[:, 0]
    M = M0s[st0]                                           # (LP, N, d)
    C = C0s[st0][:, None].expand(L * P, q, *C0s.shape[1:])  # (LP, q, N, N)
    acc = torch.zeros((L * P,), dtype=ydata.dtype, device=dev)

    def observe(t, M, C, acc):
        M_u, C_u, ll = kalman_update_batch(M, C, ydata[lane, t], w, s2, Cind)
        v = valid[lane, t]                                 # (LP,)
        return (torch.where(v[:, None, None], M_u, M),
                torch.where(v[:, None, None, None], C_u, C),
                acc + torch.where(v, ll, 0.0))

    M, C, acc = observe(0, M, C, acc)
    for t in range(1, T):
        st = prof[:, t]
        B = Bs[st]                                         # (LP, N, N)
        M = torch.bmm(B, M) + Gs[st]
        X = torch.einsum("pij,pqjk->pqik", B, C)
        C = torch.einsum("pqik,pkj->pqij", X, B) + Sigs[st][:, None]
        if symmetrize:
            C = 0.5 * (C + C.transpose(-1, -2))
        M, C, acc = observe(t, M, C, acc)

    acc = acc.view(L, P)
    out = torch.where(in_range_mask(profiles, n), acc,
                      torch.full_like(acc, math.nan))
    return out[0] if single else out


def msrouse_logL_batch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                       profiles, ydata, valid, symmetrize=True):
    """
    Log-likelihoods of profile batches, ``(L, P)`` for L lanes.

    ``Bs, Sigs, C0s (n, N, N)``, ``Gs, M0s (n, N, d)``, ``w (N,)``,
    ``s2 (q,)``, ``Cind (d,)``, ``profiles (L, P, T)`` int, ``ydata (L, T,
    d)`` (zeros at missing frames), ``valid (L, T)`` bool; or the
    single-lane form ``(P, T)``, ``(T, d)``, ``(T,)`` with a ``(P,)``
    result. The initial condition is selected by ``profiles[..., 0]``;
    ``symmetrize`` re-symmetrizes the covariance each frame. Out-of-range
    states give NaN.
    """
    msrouse_logL_batch.calls += 1
    return logL_dense_loop(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,
                           ydata, valid, symmetrize)


msrouse_logL_batch.calls = 0
