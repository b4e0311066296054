"""
Temporal-parallel (associative-scan) Kalman likelihood (counterpart of
`bild_tpu.experimental.assoc_kalman`).

The sequential likelihoods (`ops.kalman`, the CUDA kernels) parallelize
over profiles and walk the frames in order. This module evaluates the same
likelihood with an associative scan over time, the linear-Gaussian
filtering formulation of Särkkä & García-Fernández, "Temporal
Parallelization of Bayesian Smoothers" (IEEE TAC 2021): each frame is a
conditional-Gaussian element ``(A, b, C, J, h)`` and the filtered states
are the prefixes of their associative composition, O(log T) deep. With a
``time`` mesh (`parallel.mesh.make_mesh`) each rank scans its own block of
frames, and the ranks exchange only their blocks' totals.

Spatial dimensions are independent single-output models sharing the state
dynamics; profiles and dimensions are leading tensor axes. ``profile[0]``
selects the initial steady state, observed frames update, missing frames
only propagate, as in `ops.kalman`.

Experimental, as in `bild_tpu`: no default path dispatches here;
`MultiStateRouse.logL_batch_assoc` is the explicit opt-in.
"""
from __future__ import annotations

import math

import torch

from ..config import full_fp32
from ..ops.kalman import in_range_mask

LOG_2PI = math.log(2.0 * math.pi)

__all__ = ["msrouse_logL_assoc", "msrouse_logL_assoc_batch",
           "associative_scan"]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _compose(e1, e2):
    """Associative composition of filtering elements (Lemma 8 of the
    paper); ``e1`` is the earlier block, ``e2`` the later. Leaves carry the
    same leading batch axes. ``D = I + C1 J2`` is factored once and serves
    both solves (``E = I + J2 C1 = D^T``)."""
    A1, b1, C1, J1, h1 = e1
    A2, b2, C2, J2, h2 = e2
    N = A1.shape[-1]
    D = torch.eye(N, dtype=A1.dtype, device=A1.device) + C1 @ J2
    LU, piv, _ = torch.linalg.lu_factor_ex(D)
    X = torch.linalg.lu_solve(
        LU, piv, torch.cat([A1, (b1 + _mv(C1, h2))[..., None], C1], dim=-1))
    Dinv_A1, Dinv_bh, Dinv_C1 = X[..., :N], X[..., N], X[..., N + 1:]
    A = A2 @ Dinv_A1
    b = _mv(A2, Dinv_bh) + b2
    C = A2 @ Dinv_C1 @ A2.mT + C2
    Y = torch.linalg.lu_solve(
        LU, piv, torch.cat([(h2 - _mv(J2, b1))[..., None], J2], dim=-1),
        adjoint=True)
    Einv_hb, Einv_J2 = Y[..., 0], Y[..., 1:]
    A1T = A1.mT
    h = _mv(A1T, Einv_hb) + h1
    J = A1T @ Einv_J2 @ A1 + J1
    return A, b, C, J, h


def _take(x, dim, start, stop=None, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def associative_scan(fn, elems, dim=0):
    """Inclusive scan of ``elems`` (a tuple of tensors sharing axis ``dim``,
    counted from the front) under the associative ``fn(earlier, later)``,
    which maps batches of elements along that axis: element ``t`` of the
    result is ``e_0 . e_1 . ... . e_t``. Any length, 1 included. Adjacent
    pairs are combined, the half-length sequence is scanned, and the even
    positions are filled in (the recursion of `jax.lax.associative_scan`);
    the grouping of the products may differ from JAX's, the algebra does
    not."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    pairs = fn(tuple(_take(x, dim, 0, n - 1, 2) for x in elems),
               tuple(_take(x, dim, 1, None, 2) for x in elems))
    odd = associative_scan(fn, pairs, dim)             # prefixes at 1, 3, ...
    rest = tuple(_take(x, dim, 2, None, 2) for x in elems)
    if n % 2 == 0:                                      # prefixes at 2, 4, ...
        even = fn(tuple(_take(x, dim, 0, -1) for x in odd), rest)
    else:
        even = fn(odd, rest)
    out = []
    for x, o, e in zip(elems, odd, even):
        ev = torch.cat([_take(x, dim, 0, 1), e], dim=dim)   # (n + 1) // 2
        k = n // 2
        woven = torch.stack([_take(ev, dim, 0, k), o], dim=dim + 1)
        woven = woven.flatten(dim, dim + 1)
        if n % 2:
            woven = torch.cat([woven, _take(ev, dim, k)], dim=dim)
        out.append(woven)
    return tuple(out)


def _frame_elements(F, Q, y, valid, w, s2d):
    """Elements of observed and missing frames: ``F, Q (t, P, N, N)`` the
    frames' dynamics, ``y (t, d)``, ``valid (t,)``, ``s2d (d,)``. Returns the
    elements ``(t, P, d, ...)``, ``F^T w (t, P, N)`` and the innovation
    variance's model part plus noise ``S = w Q w + s2 (t, P, d)``."""
    N = F.shape[-1]
    I = torch.eye(N, dtype=F.dtype, device=F.device)
    Qw = _mv(Q, w)[:, :, None, :]                               # (t, P, 1, N)
    S = (Qw * w).sum(-1) + s2d                                  # (t, P, d)
    K = Qw / S[..., None]                                       # (t, P, d, N)
    ImKH = I - K[..., :, None] * w                              # (t, P, d, N, N)
    Fw = _mv(F.mT, w)                                           # (t, P, N)
    yv = y[:, None, :]                                          # (t, 1, d)
    v2 = valid[:, None, None, None]
    v3 = valid[:, None, None, None, None]
    F3, Q3 = F[:, :, None], Q[:, :, None]
    A = torch.where(v3, ImKH @ F3, F3)
    b = torch.where(v2, K * yv[..., None], 0.0)
    C = torch.where(v3, ImKH @ Q3, Q3)
    h = torch.where(v2, Fw[:, :, None, :] * (yv / S)[..., None], 0.0)
    J = torch.where(v3, (Fw[..., :, None] * Fw[..., None, :])[:, :, None]
                    / S[..., None, None], 0.0)
    return (A, b, C, J, h), Fw, S


def _first_element(m0, C0, y0, valid0, w, s2d):
    """The element of frame 0: the steady state ``m0 (P, d, N)``, ``C0 (P,
    N, N)``, updated by ``y0 (d,)`` when frame 0 is observed, with ``A = J
    = 0``; and frame 0's ``(P, d)`` log-density (0 when it is missing)."""
    N = C0.shape[-1]
    I = torch.eye(N, dtype=C0.dtype, device=C0.device)
    C0w = _mv(C0, w)[:, None, :]                                # (P, 1, N)
    S0 = (C0w * w).sum(-1) + s2d                                # (P, d)
    K0 = C0w / S0[..., None]                                    # (P, d, N)
    innov = y0 - _mv(m0, w)                                     # (P, d)
    ll0 = torch.where(valid0, -0.5 * (innov ** 2 / S0 + torch.log(S0)
                                      + LOG_2PI), 0.0)
    b0 = torch.where(valid0, m0 + K0 * innov[..., None], m0)
    C0d = C0[:, None].expand(-1, S0.shape[1], N, N)
    C0u = torch.where(valid0, (I - K0[..., :, None] * w) @ C0d, C0d)
    zero = torch.zeros_like(C0u)
    return (zero, b0, C0u, zero, torch.zeros_like(b0)), ll0


def _predictive(F_w, S, m_prev, P_prev, y, valid):
    """``(P,)`` sum over frames and dimensions of the predictive
    log-densities of observed frames, from the previous filtered means
    ``m_prev (t, P, d, N)`` and covariances ``P_prev (t, P, d, N, N)``."""
    mu = (m_prev * F_w[:, :, None, :]).sum(-1)                  # (t, P, d)
    var = (_mv(P_prev, F_w[:, :, None, :]) * F_w[:, :, None, :]).sum(-1) + S
    ll = -0.5 * ((y[:, None, :] - mu) ** 2 / var + torch.log(var) + LOG_2PI)
    return torch.where(valid[:, None, None], ll, 0.0).sum(dim=(0, 2))


def msrouse_logL_assoc_batch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,
                             ydata, valid, mesh=None, time_axis="time"):
    """
    ``(P,)`` log-likelihoods of ``profiles (P, T)`` through the
    temporal-parallel filter, with the arguments of
    `ops.kalman.msrouse_logL_batch`'s single-lane form (``ydata (T, d)``
    with zeros at missing frames). ``Gs`` must be zero (no external force,
    true of every model in this package); it is not read.

    With a ``mesh`` (`parallel.mesh.make_mesh`, axis ``time_axis``) the
    arguments are the whole trajectory on every rank; rank ``i`` of ``W``
    takes frames ``[i T/W, (i+1) T/W)`` (``ValueError`` on every rank when
    W does not divide T), scans them, and composes the totals of the ranks
    before it (one all-gather); one sum all-reduce gives every rank the
    whole result. Matrix products in full float32 (`config.full_fp32`).
    Out-of-range states give NaN. A singular composition gives non-finite
    values, as `bild_tpu`'s solves do; nothing is retried elsewhere.
    """
    T = profiles.shape[1]
    W, r = 1, 0
    if mesh is not None:
        if time_axis not in mesh.shape:
            raise ValueError(f"mesh has no '{time_axis}' axis: axes "
                             f"{tuple(mesh.shape)}")
        W, r = mesh.shape[time_axis], mesh.index
        if T % W:
            raise ValueError(f"{T} frames are not divisible by the mesh "
                             f"'{time_axis}' axis ({W})")
    with full_fp32():
        out = _assoc_block(Bs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata,
                           valid, T // W, r, W, mesh)
    if mesh is not None:
        from ..parallel.mesh import all_reduce_sum
        out = all_reduce_sum(out, mesh)
    return out


def _assoc_block(Bs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata, valid,
                 Tb, r, W, mesh):
    """Rank ``r``'s ``(P,)`` share of the log-likelihood: frames ``[r Tb,
    (r+1) Tb)`` of ``W`` blocks, the exclusive prefix of the ranks before
    it applied."""
    n = Bs.shape[0]
    dev = ydata.device
    lo, hi = r * Tb, (r + 1) * Tb
    prof = profiles.long().clamp(0, n - 1)
    Cind = torch.as_tensor(Cind, dtype=torch.long, device=dev)
    s2d = s2[Cind]                                              # (d,)
    blk = prof[:, lo:hi].T                                      # (Tb, P)
    F, Q = Bs[blk], Sigs[blk]                                   # (Tb, P, N, N)
    y, v = ydata[lo:hi], valid[lo:hi]
    s = 1 if r == 0 else 0                  # frame 0 is rank 0's first
    elems, F_w, S = _frame_elements(F[s:], Q[s:], y[s:], v[s:], w, s2d)
    out = torch.zeros(prof.shape[0], dtype=ydata.dtype, device=dev)
    if r == 0:
        first, ll0 = _first_element(M0s[prof[:, 0]].transpose(1, 2),
                                    C0s[prof[:, 0]], y[0], v[0], w, s2d)
        elems = tuple(torch.cat([f[None], e]) for f, e in zip(first, elems))
        out = out + ll0.sum(-1)
    elems = associative_scan(_compose, elems, dim=0)
    if W > 1:
        prefix = _exclusive_prefix(tuple(e[-1] for e in elems), r, mesh)
        if r > 0:
            elems = _compose(tuple(p.expand_as(e) for p, e in
                                   zip(prefix, elems)), elems)
    _, b_f, C_f, _, _ = elems
    if r == 0:
        m_prev, P_prev = b_f[:-1], C_f[:-1]
    else:
        m_prev = torch.cat([prefix[1][None], b_f[:-1]])
        P_prev = torch.cat([prefix[2][None], C_f[:-1]])
    out = out + _predictive(F_w, S, m_prev, P_prev, y[s:], v[s:])
    return torch.where(in_range_mask(profiles[:, lo:hi], n), out,
                       torch.full_like(out, math.nan))


def _exclusive_prefix(total, r, mesh):
    """The composition of the block totals of the ranks before rank ``r``
    (None for rank 0, whose prefix is the identity), from one all-gather of
    every rank's ``total``."""
    from ..parallel.mesh import all_gather_tensor

    shapes = [x.shape for x in total]
    flat = torch.cat([x.reshape(-1) for x in total])
    every = all_gather_tensor(flat, mesh)                       # (W, numel)
    if r == 0:
        return None
    sizes = [math.prod(sh) for sh in shapes]
    blocks = [tuple(p.reshape(sh) for p, sh in zip(row.split(sizes), shapes))
              for row in every[:r]]
    prefix = blocks[0]
    for blk in blocks[1:]:
        prefix = _compose(prefix, blk)
    return prefix


def msrouse_logL_assoc(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profile, ydata,
                       valid):
    """
    Log-likelihood (a 0-d tensor) of ONE profile ``(T,)`` through the
    temporal-parallel filter: the arguments of `ops.kalman`'s single-lane
    form with one profile. ``Gs`` must be zero (no external force, true of
    every model in this package). `msrouse_logL_assoc_batch` takes a batch.
    """
    profile = torch.as_tensor(profile, device=ydata.device)
    return msrouse_logL_assoc_batch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                                    profile[None], ydata, valid)[0]
