"""
Dirichlet proposal over switch-interval fractions ``s`` (counterpart of
`bild_tpu.amis.dirichlet`).

Every function takes an optional leading lane axis (one lane per
independent sampler of the lockstep runner); reductions over a lane's own
axes go through `lanes.lane_sum`; with ``exact=True`` (the lockstep
runner) a lane's numbers do not depend on how many lanes share the call.

Sampling draws from a `torch.Generator` or a `lanes.LaneRNG`. PyTorch's
own gamma sampler takes neither, so `standard_gamma` is a Marsaglia-Tsang
sampler on uniform and normal draws.
"""
from __future__ import annotations

import math

import torch

from ..lanes import lane_sum, normal, uniform

__all__ = ["standard_gamma", "dirichlet_logpdf", "dirichlet_estimate",
           "dirichlet_sample_masked"]


def standard_gamma(alpha: torch.Tensor, generator=None) -> torch.Tensor:
    """
    One Gamma(alpha, 1) draw per entry of ``alpha`` (all > 0); with a
    `LaneRNG`, ``alpha``'s first axis is the lane axis.

    Marsaglia & Tsang (2000): with ``d = a - 1/3``, ``c = 1/sqrt(9d)``,
    ``x ~ N(0,1)``, ``v = (1 + c x)^3``, accept ``d v`` when ``v > 0`` and
    ``log u < x^2/2 + d - d v + d log v``. Every round draws for all entries
    and keeps the first acceptance; rejections are a few percent, so a few
    rounds suffice, and the loop asks the device once per round whether
    every entry of every lane is done. ``alpha < 1`` samples
    Gamma(alpha + 1) and multiplies by ``u^(1/alpha)``; in float32 that
    product underflows to exactly 0 for small ``alpha``, which
    `dirichlet_logpdf` handles.
    """
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    rnd = 0
    while True:
        x = normal(generator, a.shape, 2 * rnd, a.dtype, a.device)
        u = uniform(generator, a.shape, 2 * rnd + 1, a.dtype, a.device)
        v = (1.0 + c * x) ** 3
        pos = v > 0
        logv = torch.log(torch.where(pos, v, 1.0))
        ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
        rnd += 1
        if not bool(todo.any()):
            break
    u = uniform(generator, a.shape, -1, a.dtype, a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def dirichlet_sample_masked(generator, a, active, N, exact=False):
    """
    ``(N, K)`` Dirichlet draws over the ``active`` slots, or ``(L, N, K)``
    for lane-batched ``a, active (L, K)``; padded slots get exactly 0 (they
    never produce a switch in `st2profile`). With every slot active this is
    an ordinary Dirichlet sample. ``exact``: lane-exact normalization
    (`lanes.lane_sum`).
    """
    if a.dim() == 1:
        return dirichlet_sample_masked(generator, a[None], active[None], N,
                                       exact)[0]
    L, K = a.shape
    alpha = torch.where(active, a, torch.ones_like(a))[:, None, :].expand(L, N, K)
    g = standard_gamma(alpha, generator)
    g = torch.where(active[:, None, :], g, torch.zeros_like(g))
    return g / lane_sum(g, dim=-1, keepdim=True, exact=exact)


def dirichlet_logpdf(a, ss, active=None, exact=False):
    """
    Log-density of Dirichlet(a) at samples ``ss`` -> ``(..., N)``:
    parameters ``a (..., K)`` and samples ``ss (..., N, K)`` broadcast as
    ``a[..., None, :]`` against ``ss`` (a leading parameter axis evaluates
    several proposals on the same samples; a leading lane axis pairs each
    lane's parameters with its samples). ``active`` (bool, broadcastable to
    ``a``) restricts the distribution to a slot subset; ``exact`` makes
    the sums lane-exact (`lanes.lane_sum`).

    A zero coordinate contributes +inf when its ``a < 1`` (the density
    diverges), -inf when ``a > 1``, and 0 when ``a == 1``.
    """
    if active is None:
        lognorm = (lane_sum(torch.lgamma(a), exact=exact)
                   - torch.lgamma(lane_sum(a, exact=exact)))
    else:
        zero = torch.zeros_like(a)
        lognorm = (lane_sum(torch.where(active, torch.lgamma(a), zero),
                            exact=exact)
                   - torch.lgamma(lane_sum(torch.where(active, a, zero),
                                           exact=exact)))
    a = a[..., None, :]                                     # (..., 1, K)
    is_zero = ss <= 0
    inf = torch.full_like(a, math.inf)
    edge = torch.where(a < 1, inf, torch.where(a > 1, -inf, torch.zeros_like(a)))
    terms = torch.where(is_zero, edge,
                        (a - 1) * torch.log(torch.where(is_zero, 1.0, ss)))
    if active is not None:
        terms = torch.where(active[..., None, :], terms, torch.zeros_like(terms))
    return lane_sum(terms, exact=exact) - lognorm[..., None]


def dirichlet_estimate(ss, log_weights, active=None, exact=False):
    """
    Weighted method-of-moments estimate from samples ``ss (..., M, K)``
    with log-weights ``(..., M)``: mean positions m, variances v, total
    concentration ``A = mean(m(1-m)/v) - 1``, result ``A*m`` ``(..., K)``.
    Degenerate (zero-variance) ensembles give a very concentrated finite
    distribution. An over-dispersed ensemble can give ``A <= 0``, an invalid
    concentration, returned as is: `amis_update` then keeps the previous
    proposal. Inactive slots (``active (..., K)``) return concentration 1.
    ``exact`` makes the sums lane-exact (`lanes.lane_sum`).
    """
    w = torch.exp(log_weights - log_weights.amax(dim=-1, keepdim=True))
    w = w / lane_sum(w, dim=-1, keepdim=True, exact=exact)
    m = lane_sum(w[..., None] * ss, dim=-2, exact=exact)    # (..., K)
    v = lane_sum(w[..., None] * (ss - m[..., None, :]) ** 2, dim=-2,
                 exact=exact)

    # the tolerance guards pure round-off variance and scales with the
    # dtype's machine epsilon
    eps = torch.finfo(ss.dtype).eps
    degenerate = v <= (50 * eps) ** 2
    if active is not None:
        degenerate = degenerate & active
    safe_v = torch.where(degenerate | (v <= 0), torch.ones_like(v), v)
    ratio = m * (1 - m) / safe_v
    if active is None:
        s = lane_sum(ratio, exact=exact) / ratio.shape[-1] - 1
    else:
        s = lane_sum(torch.where(active, ratio, torch.zeros_like(ratio)),
                     exact=exact) / active.sum(dim=-1) - 1
    s = torch.where(degenerate.any(dim=-1), torch.full_like(s, 1e10), s)
    out = s[..., None] * m
    if active is not None:
        out = torch.where(active, out, torch.ones_like(out))
    return out
