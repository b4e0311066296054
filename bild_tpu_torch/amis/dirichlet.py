"""
Dirichlet proposal over switch-interval fractions ``s`` (counterpart of
`bild_tpu.amis.dirichlet`).

Sampling draws from an explicit `torch.Generator`. PyTorch's own gamma
sampler takes no generator, so `standard_gamma` is a Marsaglia-Tsang
sampler on ``torch.randn``/``torch.rand``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["standard_gamma", "dirichlet_logpdf", "dirichlet_estimate",
           "dirichlet_sample_masked"]


def standard_gamma(alpha: torch.Tensor, generator=None) -> torch.Tensor:
    """
    One Gamma(alpha, 1) draw per entry of ``alpha`` (all > 0).

    Marsaglia & Tsang (2000): with ``d = a - 1/3``, ``c = 1/sqrt(9d)``,
    ``x ~ N(0,1)``, ``v = (1 + c x)^3``, accept ``d v`` when ``v > 0`` and
    ``log u < x^2/2 + d - d v + d log v``. Every round draws for all entries
    and keeps the first acceptance; rejections are a few percent, so a few
    rounds suffice. ``alpha < 1`` samples Gamma(alpha + 1) and multiplies by
    ``u^(1/alpha)``; in float32 that product underflows to exactly 0 for
    small ``alpha``, which `dirichlet_logpdf` handles.
    """
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while True:
        x = torch.randn(a.shape, generator=generator, dtype=a.dtype,
                        device=a.device)
        u = torch.rand(a.shape, generator=generator, dtype=a.dtype,
                       device=a.device)
        v = (1.0 + c * x) ** 3
        pos = v > 0
        logv = torch.log(torch.where(pos, v, 1.0))
        ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
        if not bool(todo.any()):
            break
    u = torch.rand(a.shape, generator=generator, dtype=a.dtype, device=a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def dirichlet_sample_masked(generator, a, active, N):
    """
    ``(N, K)`` Dirichlet draws over the ``active`` slots; padded slots get
    exactly 0 (they never produce a switch in `st2profile`). With every
    slot active this is an ordinary Dirichlet sample.
    """
    alpha = torch.where(active, a, torch.ones_like(a)).expand(N, a.shape[0])
    g = standard_gamma(alpha, generator)
    g = torch.where(active[None, :], g, torch.zeros_like(g))
    return g / g.sum(dim=-1, keepdim=True)


def dirichlet_logpdf(a, ss, active=None):
    """
    Log-density of Dirichlet(a) at samples ``ss (N, K)`` -> ``(..., N)`` for
    parameters ``a (..., K)`` (a leading axis evaluates several proposals).

    A zero coordinate contributes +inf when its ``a < 1`` (the density
    diverges), -inf when ``a > 1``, and 0 when ``a == 1``. ``active``
    (bool ``(K,)``) restricts the distribution to a slot subset.
    """
    if active is None:
        lognorm = torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))
    else:
        zero = torch.zeros_like(a)
        lognorm = (torch.where(active, torch.lgamma(a), zero).sum(-1)
                   - torch.lgamma(torch.where(active, a, zero).sum(-1)))
    a = a[..., None, :]                                     # (..., 1, K)
    is_zero = ss <= 0
    inf = torch.full_like(a, math.inf)
    edge = torch.where(a < 1, inf, torch.where(a > 1, -inf, torch.zeros_like(a)))
    terms = torch.where(is_zero, edge,
                        (a - 1) * torch.log(torch.where(is_zero, 1.0, ss)))
    if active is not None:
        terms = torch.where(active, terms, torch.zeros_like(terms))
    return terms.sum(-1) - lognorm[..., None]


def dirichlet_estimate(ss, log_weights, active=None):
    """
    Weighted method-of-moments estimate: mean positions m, variances v,
    total concentration ``A = mean(m(1-m)/v) - 1``, result ``A*m``.
    Degenerate (zero-variance) ensembles give a very concentrated finite
    distribution. An over-dispersed ensemble can give ``A <= 0``, an invalid
    concentration, returned as is: `amis_update` then keeps the previous
    proposal. Inactive slots return concentration 1.
    """
    w = torch.exp(log_weights - log_weights.max())
    w = w / w.sum()
    m = w @ ss
    v = w @ (ss - m[None, :]) ** 2

    # the tolerance guards pure round-off variance and scales with the
    # dtype's machine epsilon
    eps = torch.finfo(ss.dtype).eps
    degenerate = v <= (50 * eps) ** 2
    if active is not None:
        degenerate = degenerate & active
    safe_v = torch.where(degenerate | (v <= 0), torch.ones_like(v), v)
    ratio = m * (1 - m) / safe_v
    if active is None:
        s = ratio.mean() - 1
    else:
        s = torch.where(active, ratio, torch.zeros_like(ratio)).sum() \
            / active.sum() - 1
    s = torch.where(degenerate.any(), torch.full_like(s, 1e10), s)
    out = s * m
    if active is not None:
        out = torch.where(active, out, torch.ones_like(out))
    return out
