"""
Lane-exact building blocks of the lockstep runner.

The dataset runner (`parallel.batch`) advances many independent AMIS
samplers at once, one per lane: a (switch count, trajectory) pair. A lane's
result must not depend on which other lanes share its tensors, so that
the all-k ("fused") schedule, the per-k checkpointed schedule and any
chunking of a dataset give the same numbers for the same seed. Two things
would break that in plain PyTorch:

- Reductions. PyTorch's reduction kernels choose their summation order
  from the shape of the whole tensor, so the float sum over one lane's
  slice can change in its last bits with the number of lanes. With
  ``exact=True``, `lane_sum`, `lane_logsumexp` and `lane_cumsum` reduce
  with a fixed order of elementwise additions instead (a pairwise tree;
  left to right for the cumulative sum): each slice's result depends on
  that slice alone, on any device. That costs a few kernel launches per
  tree level, so the lockstep runner asks for it at its call sites and a
  single sampler (no other lane exists) keeps the default, PyTorch's own
  reductions. (Maxima, arg-maxima and integer sums are exact in any order
  and always use PyTorch's kernels.)
- Random numbers. A `torch.Generator` hands out one stream, so a lane's
  draws would depend on the lanes drawn before it. `LaneRNG` gives every
  lane its own counter-based stream: a value is a SplitMix64 hash of the
  lane's 64-bit key, a call tag and the element's index, computed for all
  lanes in a few integer tensor operations, with no host synchronization.

`uniform` and `normal` draw from either kind of source, so the samplers
take a `torch.Generator` (the single-trajectory `FixedkSampler`, whose
draws stay those of the generator) or a `LaneRNG`.
"""
from __future__ import annotations

import math

import torch

__all__ = ["lane_sum", "lane_logsumexp", "lane_cumsum",
           "LaneRNG", "uniform", "normal", "mix64", "mix_int"]

def lane_sum(x: torch.Tensor, dim: int = -1, keepdim: bool = False, *,
             exact: bool = False):
    """Sum along ``dim``. With ``exact``, by a fixed pairwise tree of
    elementwise additions: zero-padded to a power of two, then
    ``x[..., :h] + x[..., h:]`` halving until one entry is left, so the
    result for each slice does not depend on the other dimensions."""
    if not exact:
        return x.sum(dim=dim, keepdim=keepdim)
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim=dim, keepdim=keepdim)
    size = 1 << (n - 1).bit_length()
    if size != n:
        pad = list(x.shape)
        pad[dim] = size - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while size > 1:
        size //= 2
        x = x.narrow(dim, 0, size) + x.narrow(dim, size, size)
    return x if keepdim else x.squeeze(dim)


def lane_logsumexp(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
                   *, exact: bool = False):
    """``log(sum(exp(x)))`` along ``dim``; with ``exact``, through the
    exact `lane_sum`: -inf where the slice is all -inf (or empty), +inf
    where it holds +inf, NaN where it holds NaN, as `torch.logsumexp`."""
    if not exact or x.shape[dim] == 0:
        return torch.logsumexp(x, dim=dim, keepdim=keepdim)
    m = x.amax(dim=dim, keepdim=True).nan_to_num(nan=0.0, posinf=0.0,
                                                  neginf=0.0)
    out = torch.log(lane_sum(torch.exp(x - m), dim=dim, keepdim=True,
                             exact=True)) + m
    return out if keepdim else out.squeeze(dim)


def lane_cumsum(x: torch.Tensor, *, exact: bool = False) -> torch.Tensor:
    """Cumulative sum along the last axis; with ``exact``, left to right in
    elementwise additions."""
    if not exact:
        return torch.cumsum(x, dim=-1)
    out = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., i])
    return torch.stack(out, dim=-1)


# -- counter-based random streams -------------------------------------------

def _i64(c: int) -> int:
    """A 64-bit constant as the signed value int64 tensors hold."""
    return c - 2**64 if c >= 2**63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_M1 = _i64(0xBF58476D1CE4E5B9)
_M2 = _i64(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (``>>`` on a signed tensor is
    arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer on int64 tensors (wrapping arithmetic)."""
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def mix_int(x: int) -> int:
    """`mix64` of one Python int, on the host."""
    x &= 2**64 - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return _i64(x ^ (x >> 31))


class LaneRNG:
    """
    Independent random streams, one per lane. ``keys`` is an ``(L,)``
    int64 tensor on the device the draws are made on. `fold` derives the
    streams of a sub-task (a step, a call site, a rejection round) from a
    host int; a draw of shape ``(L, *shape)`` at tag ``t`` gives element
    ``i`` of lane ``l`` the value ``mix64(mix64(keys[l] ^ c(t)) + (i+1) G)``
    with G the golden-ratio increment of SplitMix64, so a lane's values
    depend only on its key, the tags and the element index.
    """

    def __init__(self, keys: torch.Tensor):
        if keys.dtype != torch.int64 or keys.dim() != 1:
            raise ValueError("LaneRNG keys must be an (L,) int64 tensor")
        self.keys = keys

    @staticmethod
    def from_seeds(seeds, device) -> "LaneRNG":
        """Streams keyed by host integers (any shape; flattened)."""
        keys = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1)
        return LaneRNG(mix64(keys).to(device))

    @property
    def lanes(self) -> int:
        return self.keys.shape[0]

    def fold(self, tag: int) -> "LaneRNG":
        return LaneRNG(mix64(self.keys ^ mix_int(tag + 0x632BE59BD9B4E019)))

    def __getitem__(self, idx) -> "LaneRNG":
        """The streams of a subset of lanes (an index tensor or slice)."""
        return LaneRNG(self.keys[idx])

    def bits(self, shape, tag: int) -> torch.Tensor:
        """``(L, *shape)`` uniformly distributed int64 words."""
        M = math.prod(shape)
        idx = torch.arange(1, M + 1, dtype=torch.int64, device=self.keys.device)
        base = self.fold(tag).keys
        return mix64(base[:, None] + idx[None, :] * _GOLDEN).view(
            self.lanes, *shape)

    def uniform(self, shape, tag: int, dtype) -> torch.Tensor:
        """``(L, *shape)`` uniforms in the open interval (0, 1), with the
        top 24 (float32) or 53 (float64) bits of each word."""
        b = self.bits(shape, tag)
        nbits = 24 if dtype == torch.float32 else 53
        return (_shr(b, 64 - nbits).to(dtype) + 0.5) * 2.0 ** -nbits


def uniform(source, shape, tag: int, dtype, device) -> torch.Tensor:
    """``shape`` uniforms from a `LaneRNG` (``shape[0]`` is its lane count;
    ``tag`` names the call) or a `torch.Generator`/``None`` (``tag`` is
    ignored: the generator's stream is consumed in call order, in [0, 1))."""
    if isinstance(source, LaneRNG):
        if shape[0] != source.lanes:
            raise ValueError(f"draw of shape {tuple(shape)} from "
                             f"{source.lanes} lanes")
        return source.uniform(tuple(shape[1:]), tag, dtype)
    return torch.rand(shape, generator=source, dtype=dtype, device=device)


def normal(source, shape, tag: int, dtype, device) -> torch.Tensor:
    """Standard normals, sources as `uniform`. A `LaneRNG` draw is a
    Box-Muller transform of two uniforms from the streams folded by
    ``tag``."""
    if isinstance(source, LaneRNG):
        sub = source.fold(tag)
        u1 = uniform(sub, shape, 0, dtype, device)
        u2 = uniform(sub, shape, 1, dtype, device)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)
    return torch.randn(shape, generator=source, dtype=dtype, device=device)
