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

from ..lanes import LaneRNG, lane_sum, normal, uniform
from ..ops import _build, counters

__all__ = ["Dirichlet", "standard_gamma", "dirichlet_logpdf",
           "dirichlet_estimate", "dirichlet_sample_masked", "gamma_accept",
           "check_exhausted", "gamma_plan", "GAMMA_MAX_ROUNDS"]

# The most rounds an entry of the sampler on `LaneRNG` streams draws. A
# round accepts with probability >= 0.95 for a >= 1 in float64, but in
# float32 the test cancels for large shapes (a >= 1e8, as a degenerate
# proposal's concentration gives) and accepts about half the draws: an
# entry then needs tens of rounds. Short of a NaN shape, 1000 is never
# reached.
GAMMA_MAX_ROUNDS = 1000

# The gamma kernel's grid (csrc/gamma_accept.cu, `gamma_plan`): a block of
# `GAMMA_THREADS` threads serves one contiguous range of one lane's
# entries, at most `GAMMA_MAX_SPAN` of them; a lane is cut into more ranges
# where that brings the launch to `GAMMA_MIN_BLOCKS` blocks (two per SM of
# the H100) without leaving a thread less than one entry. The block
# computes its lane's stream words of the first `GAMMA_HOISTED_ROUNDS`
# rounds once (the kernel's kHoisted). 128 threads measured faster than 64
# or 256 at config 3's scout shape on the H100.
GAMMA_THREADS = 128
GAMMA_MAX_SPAN = 1024
GAMMA_MIN_BLOCKS = 264
GAMMA_HOISTED_ROUNDS = 8


def gamma_plan(L: int, per_lane: int):
    """``(blocks_per_lane, span, threads)`` of the gamma kernel for ``L``
    lanes of ``per_lane`` entries: block ``b`` serves entries ``[k span,
    min((k + 1) span, per_lane))`` of lane ``b // blocks_per_lane``, ``k =
    b % blocks_per_lane``; no range is empty, and together they cover each
    lane once (the kernel refuses a plan that does not)."""
    blocks = max(-(-per_lane // GAMMA_MAX_SPAN),
                 min(-(-per_lane // GAMMA_THREADS), -(-GAMMA_MIN_BLOCKS // L)))
    span = -(-per_lane // blocks)
    return -(-per_lane // span), span, GAMMA_THREADS


def check_exhausted(flag) -> None:
    """Raise if ``flag`` (a 0-d bool tensor that `gamma_accept` sets, or a
    bool) says an entry went unaccepted in `GAMMA_MAX_ROUNDS` rounds: one
    host read. Counts each such event in ``standard_gamma.exhausted``."""
    if bool(flag):
        standard_gamma.exhausted += 1
        raise RuntimeError(
            f"standard_gamma: an entry was not accepted in {GAMMA_MAX_ROUNDS} "
            "rejection rounds (a NaN or infinite shape?); its draw would be "
            "wrong, so the run stops")


def _gamma_round(generator, rnd, d, c, out, todo):
    """One Marsaglia-Tsang round: draws at tags ``2 rnd`` (normals) and ``2
    rnd + 1`` (uniforms); entries still ``todo`` keep their first
    acceptance ``d v``."""
    x = normal(generator, d.shape, 2 * rnd, d.dtype, d.device)
    u = uniform(generator, d.shape, 2 * rnd + 1, d.dtype, d.device)
    v = (1.0 + c * x) ** 3
    pos = v > 0
    logv = torch.log(torch.where(pos, v, 1.0))
    ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
    return torch.where(todo & ok, d * v, out), todo & ~ok


def _gamma_accept(d, c, generator, max_rounds=None):
    """
    The plain version of `gamma_accept` (and the sampler's loop for a
    `torch.Generator`): every round draws for all entries, an entry keeps
    its first acceptance, and the loop asks the device after each round
    whether any entry is left. With ``max_rounds`` it stops there, and
    entries left set the streams' ``exhausted`` flag. Counts its calls in
    ``_gamma_accept.calls``.
    """
    _gamma_accept.calls += 1
    out = torch.zeros_like(d)
    todo = torch.ones_like(d, dtype=torch.bool)
    rnd = 0
    while True:
        out, todo = _gamma_round(generator, rnd, d, c, out, todo)
        rnd += 1
        if not bool(todo.any()):
            break
        if max_rounds is not None and rnd >= max_rounds:
            generator.exhausted.fill_(True)
            break
    return out


counters.register("plain_gamma", _gamma_accept, "calls")


def gamma_accept(d, c, generator: LaneRNG):
    """
    ``(L, ...)`` accepted Marsaglia-Tsang draws ``d v`` for shapes ``d = a
    - 1/3``, ``c = 1/sqrt(9d)`` from the lane streams ``generator``. CUDA
    tensors launch ``csrc/gamma_accept.cu`` (a block per range of a lane's
    entries, `gamma_plan`; each entry drawing until its first acceptance,
    on the current stream, no synchronization), CPU tensors run
    `_gamma_accept`; both give an entry
    the draw of the first round that accepts it, and stop at
    `GAMMA_MAX_ROUNDS`. An entry left there sets ``generator.exhausted``,
    which the streams must carry and the caller reads after its steps
    (`check_exhausted`). Counts launches in ``gamma_accept.launches``.
    """
    flag = generator.exhausted
    if flag is None:
        raise ValueError("gamma_accept: the streams carry no exhaustion flag")
    if d.device.type == "cpu":
        return _gamma_accept(d, c, generator, GAMMA_MAX_ROUNDS)
    if d.device.type != "cuda":
        raise ValueError(f"no kernel for device {d.device}")
    if d.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the gamma kernel takes float32 or float64, not {d.dtype}")
    keys = generator.keys
    L = keys.shape[0]
    if d.dim() < 1 or d.shape[0] != L or c.shape != d.shape or c.dtype != d.dtype \
            or c.device != d.device or keys.device != d.device:
        raise ValueError(f"d and c must match, with {L} lanes first, on "
                         f"{keys.device}")
    per_lane = d.numel() // L if L else 0
    if per_lane >= 2**31 - GAMMA_THREADS:
        raise ValueError(f"the gamma kernel takes fewer than 2^31 - "
                         f"{GAMMA_THREADS} entries per lane, not {per_lane}")
    d, c, keys = d.contiguous(), c.contiguous(), keys.contiguous()
    out = torch.empty_like(d)
    if d.numel() > 0:
        sfx = "f32" if d.dtype == torch.float32 else "f64"
        lib, fn = _build.entry("gamma_accept", f"bild_gamma_accept_{sfx}", 5, 7)
        rc = fn(d.data_ptr(), c.data_ptr(), keys.data_ptr(), out.data_ptr(),
                flag.data_ptr(), L, per_lane, *gamma_plan(L, per_lane),
                GAMMA_MAX_ROUNDS, d.device.index or 0,
                torch.cuda.current_stream(d.device).cuda_stream)
        gamma_accept.launches += 1
        _build.check(lib, rc, "gamma_accept launch")
    return out


counters.register("gamma_accept", gamma_accept, "launches")


def standard_gamma(alpha: torch.Tensor, generator=None) -> torch.Tensor:
    """
    One Gamma(alpha, 1) draw per entry of ``alpha`` (all > 0); with a
    `LaneRNG`, ``alpha``'s first axis is the lane axis.

    Marsaglia & Tsang (2000): with ``d = a - 1/3``, ``c = 1/sqrt(9d)``,
    ``x ~ N(0,1)``, ``v = (1 + c x)^3``, accept ``d v`` when ``v > 0`` and
    ``log u < x^2/2 + d - d v + d log v``; an entry keeps its first
    acceptance. From a `LaneRNG` the draws of round r are counter-based
    (tags 2r and 2r + 1) and `gamma_accept` runs the rounds: on CUDA one
    kernel with no host read. Streams that carry no exhaustion flag get one
    here, read at once (`check_exhausted`). From a `torch.Generator` the loop asks the
    device once per round whether every entry is done. ``alpha < 1``
    samples Gamma(alpha + 1) and multiplies by ``u^(1/alpha)``; in float32
    that product underflows to exactly 0 for small ``alpha``, which
    `dirichlet_logpdf` handles.
    """
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    if isinstance(generator, LaneRNG) and generator.exhausted is None:
        flag = torch.zeros((), dtype=torch.bool, device=d.device)
        out = gamma_accept(d, c, LaneRNG(generator.keys, flag))
        check_exhausted(flag)
    elif isinstance(generator, LaneRNG):
        out = gamma_accept(d, c, generator)
    else:
        out = _gamma_accept(d, c, generator)
    u = uniform(generator, a.shape, -1, a.dtype, a.device)
    return torch.where(boost, out * u ** (1.0 / alpha), out)


standard_gamma.exhausted = 0


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


class Dirichlet:
    """Stateless wrapper of sample / logpdf / estimate (bild_tpu's
    `amis.Dirichlet`); draws come from ``generator`` (a `torch.Generator`
    or a `lanes.LaneRNG`) where bild_tpu takes a key."""

    def sample(self, a, N=1, generator=None):
        """``(N, k+1)`` draws from Dirichlet(a)."""
        a = torch.as_tensor(a)
        return dirichlet_sample_masked(generator, a,
                                       torch.ones_like(a, dtype=torch.bool), N)

    def logpdf(self, a, ss):
        return dirichlet_logpdf(torch.as_tensor(a), torch.as_tensor(ss))

    def estimate(self, ss, log_weights):
        return dirichlet_estimate(torch.as_tensor(ss),
                                  torch.as_tensor(log_weights))
