"""
The least work of the Rouse likelihood and the card's peaks: the yardstick
of the ``logL_roofline.*`` metrics.

`kernel_work` and `bound_ms` are frozen copies of ``bench_torch.py`` at
commit c0c4c56 (there: 232.0 GFLOP and 3.463 ms at L=640, P=128, T=100 on
the README model). The work is counted from shapes, the same whichever
kernel computes it, so a share of it does not depend on which kernel the
program picked.
"""
from __future__ import annotations

__all__ = ["PEAK_FLOPS_F32", "PEAK_BYTES", "kernel_work", "bound_ms", "least_seconds"]

# NVIDIA H100 SXM data sheet, at the 700 W power limit: float32 outside the
# tensor cores (the exact kernels use none) and HBM3
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def kernel_work(L, P, T, n, N, d, q, observed):
    """``(FLOP, HBM bytes)`` that one float32 evaluation of the likelihood
    needs on these inputs, whichever kernel computes it: the least work of
    the direct recursion, C' and the downdate symmetric. ``observed``
    (lane, frame) pairs of the (L, T) mask take the measurement update,
    every profile propagates T-1 frames. Propagation, per profile-frame:
    per copy ``X = B C`` in full, ``2 N^3``, and ``C' = X B + Sig`` on the
    upper triangle, ``N (N+1) (2N+1) / 2``; the means ``d N (2N+1)``.
    Update: per copy ``Cw = C w`` (``2 N^2``), ``w.Cw`` (``2N``) and the
    downdate on the upper triangle (``N (N+1) + N``); ``w.M`` (``2 N d``),
    the mean update (``3 N d``) and the log-likelihood (``8 d``). Bytes:
    profiles, data, mask and results once, and the model's ``B, Sig, C0,
    G, M0, w`` once."""
    prop = q * (2 * N ** 3 + N * (N + 1) * (2 * N + 1) // 2) + d * N * (2 * N + 1)
    upd = q * (3 * N * N + 4 * N) + 5 * N * d + 8 * d
    ops = 3 * n * N * N + 2 * n * N * d + N
    flops = L * P * (T - 1) * prop + P * observed * upd
    nbytes = 4 * (L * P * T + L * T * d + L * P + ops) + L * T
    return flops, nbytes


def bound_ms(flops, nbytes):
    """The least time of that work on the card and what sets it."""
    t_ops, t_bytes = flops / PEAK_FLOPS_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def least_seconds(scored, n, N, d, q):
    """``(seconds, bound)``: the least time of every scored profile, each
    at its own trajectory's length and observed frames, ``scored`` a list
    of ``(profiles, T, observed)``. The profiles of one trajectory count
    that trajectory's data once; no padding is counted."""
    flops = nbytes = 0
    for profiles, T, observed in scored:
        f, b = kernel_work(1, profiles, T, n, N, d, q, observed)
        flops += f
        nbytes += b
    ms, by = bound_ms(flops, nbytes)
    return ms / 1e3, by
