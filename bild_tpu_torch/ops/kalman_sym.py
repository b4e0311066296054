"""
Packed-symmetric Rouse-Kalman likelihood: the CUDA kernel
``csrc/kalman_sym.cu`` and its plain PyTorch version.

Counterpart of `bild_tpu.ops.kalman_sym.msrouse_logL_pallas_sym` (the
Pallas kernel ``kalman_sym.py::_kernel``). The covariance is symmetric, so
only its ``PP = N(N+1)/2`` upper-triangle entries are carried, and the
conjugation ``C -> B C B^T`` is one linear operator on that packed vector,

    c' = P_s c + sig_s,     P_s[(a,b),(i,j)] = B_ai B_bj + [i<j] B_aj B_bi,

built per state on the host in float64 (`build_sym_operators`). The update
contraction ``R = U1 c`` gives ``Cw`` and ``w.C.w``; the rank-1 downdate is
``c[(a,b)] -= Cw_a Cw_b / S``. The mean propagator carries an extra
``w.B_s`` row, so the predicted measurement mean comes with it.

On the H100 the exact tier has two plans (`sym_plan`, from the launch's
shape; see the source). The tile plan: one block evaluates a tile of up
to 32 profiles of one lane (trajectory), so one launch covers a whole
lockstep AMIS step; per frame the block sorts its profiles by state and
multiplies each state's ``P_s`` (streamed from L2 in slabs) into all of
that state's packed covariances at once. The cluster plan, where even one
profile per block would leave SMs idle (``L P`` below the SM count, as
`sample()`'s single-trajectory step, L=1, P=100): a cluster of 8 blocks
keeps every state's operator rows resident in shared memory, split among
its blocks (`cluster_rows`, `row_operators`), and streams a group of the
lane's profiles through them, exchanging each frame's propagated rows
through distributed shared memory. Both give every profile the same
bits.

Operators larger than `SYM_OPERATOR_BUDGET` would no longer stay in L2,
and the dense kernel needs only ``n N^2`` operator scalars: above it the
wrapper calls `ops.kalman_dense.msrouse_logL_dense`, as the reference
falls back from its packed kernel to its dense one.

Matmul tiers (``matmul=``, bild_tpu's ``split_bf16``/``split_update``
flags; `config.set_rouse_matmul`), float32 only: ``'exact'``;
``'split_cov'``, the conjugation as three bfloat16 products with float32
sums, ``P c ~ P_hi c_hi + P_hi c_lo + P_lo c_hi`` (``hi = bf16(x)``, ``lo =
bf16(x - hi)``, round to nearest even; the operators' pairs split from
the float32-rounded operators, as the reference splits ``Pall_ref[:]``),
on the H100's tensor cores (``wgmma``) in a kernel of its own,
``csrc/kalman_sym_split.cu``; ``'split'``, the update contraction ``U1 c``
and the mean propagation ``Ballw M`` split too. In float64 every tier is
the exact one, bit for bit.

Precision. The exact tier carries the covariance recursion in float64
whatever the inputs' type: the packed ``c``, ``Cw``, ``1/S`` and the
downdate; the operators (``P_s``, ``sig``, ``Ballw``, ``Gsw``, ``w``),
the means, the data, the log-density and the result stay in the inputs'
type (float32 in, float32 out). Stored in float32 between frames the
covariance drifted over a long trajectory (0.32-0.34 nats per profile
family at T=1000 against the float64 build on an H100); carried in
float64 it reads 0.02. The split tiers keep their float32 covariance.

`msrouse_logL_sym` launches the kernel for CUDA tensors and runs
`msrouse_logL_sym_torch` for CPU tensors, with no fallback between them.
Counters: ``msrouse_logL_sym.launches`` (every launch),
``msrouse_logL_sym.split_launches`` (those of a split tier),
``msrouse_logL_sym.cluster_launches`` (those of the cluster plan),
``msrouse_logL_sym_torch.calls``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build, counters
from .kalman import LOG_2PI, as_lanes, in_range_mask
from .kalman_dense import (H100_SMS, SMEM_LIMIT, SMEM_PER_SM,
                           check_cuda_args, cind_tensor, dense_cov_itemsize,
                           msrouse_logL_dense, sm_count)

__all__ = ["SymOperators", "build_sym_operators", "msrouse_logL_sym",
           "msrouse_logL_sym_torch", "sym_fits", "sym_plan", "SymPlan",
           "auto_kernel",
           "sym_smem_bytes", "SYM_OPERATOR_BUDGET", "SYM_TILES", "TIERS",
           "SYM_CLUSTERS", "H100_CLUSTER_SLOTS", "cluster_rows",
           "row_operators",
           "update_contraction", "mean_propagation",
           "check_tier", "hi_lo", "split_product", "split_stages"]

# Bytes of the stacked packed operators (n * PPp^2 scalars) above which the
# dense kernel runs instead. Every block reads its state's P_s once per
# frame; a third of the H100's 50 MB L2 keeps all states resident beside
# the rest of the working set. In float32 this admits N <= 53 at n=2 and
# N <= 48 at n=3 (the README model, N=20 at n=2, needs 373 KB).
SYM_OPERATOR_BUDGET = 16 * 2**20


def _pad(x, pad):
    return -(-x // pad) * pad


# profiles per block of the packed kernel, largest first (at most 32: the
# block sorts its profiles by state with one warp ballot per state)
SYM_TILES = (32, 16, 8, 4, 2, 1)
# the kernel's constants (csrc/kalman_sym.cu): threads per block, operator
# columns per slab, operator rows per slab at most, covariance columns
# per thread tile, spatial dimensions at most
SYM_THREADS, _BK, _ROWS_MAX, _TN, _MAX_D = 256, 8, 256, 4, 4
# the split tiers' constants (csrc/kalman_sym_split.cu): ring stages at
# least and at most (`sym_plan` takes the most that shared memory allows),
# operator columns (k) per stage, operator rows per m-block (wgmma's m),
# columns of a block at most (wgmma's n <= 32 per state)
_STAGES, _MAX_STAGES, _DEPTH, _MB, _SPLIT_COLS = 3, 16, 32, 64, 32

TIERS = ("exact", "split", "split_cov")

# blocks per cluster of the exact tier's cluster plan, in the order tried
# (clusters of 16 fit more operator rows but measured slower at sample()'s
# step on an H100: PERF.md; `sym_plan(_force=16)` takes them)
SYM_CLUSTERS = (8,)
# clusters of each size that an H100 SXM holds at once, one block per SM
# (cudaOccupancyMaxActiveClusters on the card, NVIDIA H100 80GB HBM3 at
# 700 W: its GPCs do not all hold two clusters of 8): the plan's default
# where no device is asked, as on the CPU; the wrapper asks the device
H100_CLUSTER_SLOTS = {8: 15, 16: 7}


def check_tier(matmul) -> str:
    """``matmul`` as a tier name: None resolves from `config.rouse_matmul`
    in the ``'single'`` context (so 'auto' is 'exact' here); an unknown
    name raises ``ValueError``."""
    if matmul is None:
        from ..config import resolve_matmul
        matmul = resolve_matmul("single")
    if matmul not in TIERS:
        raise ValueError(f"matmul must be 'exact'|'split'|'split_cov', "
                         f"got {matmul!r}")
    return matmul


def _a16(nbytes):
    return -(-nbytes // 16) * 16


def split_ld(PPp) -> int:
    """Covariance column stride of the split tiers (scalars): the depth
    padded to whole stages of ``_DEPTH``, then to 4 modulo 32, so that the
    16-byte loads of 8 columns at one depth fall in 32 banks."""
    KP = _pad(PPp, _DEPTH)
    return KP + (4 - KP % 32) % 32


def cluster_rows(PP, C):
    """The operator rows of each block of a cluster of ``C``: ``range``s of
    ``PP // C`` rows, one more for the first ``PP % C`` blocks, in rank
    order (``cluster_first_row`` in ``csrc/kalman_sym.cu``)."""
    out, first = [], 0
    for rank in range(C):
        count = PP // C + (rank < PP % C)
        out.append(range(first, first + count))
        first += count
    return out


def _cluster_smem(tile, n, N, d, q, itemsize, C, cov_itemsize=8):
    """``cluster_layout`` in ``csrc/kalman_sym.cu``: the replicas of the
    cluster's ``tile * q`` packed covariances (two buffers, stride ``PPp``
    plus one 16-byte vector), the block's rows of every state's ``P_s`` (at
    most ``ceil(PP / C)`` rows of ``PPp`` plus one 16-byte vector of
    ``itemsize``-byte scalars) and of ``sig``, then as the tile layout: two
    mean buffers, ``Cw`` and ``1/S`` per column, the log-likelihoods,
    ``Ballw``, ``Gsw``, ``w``, ``s2``, one frame's data, the packed
    index table, ``Cind``, the profiles' states and three barriers (the
    operator rows', one per covariance buffer)."""
    PP = N * (N + 1) // 2
    PPp = _pad(PP, 8)
    ncol = tile * q
    rows = -(-PP // C)
    ld = PPp + 16 // cov_itemsize
    covs = (ncol * ld, ncol * ld, ncol * N, ncol)
    floats = (n * rows * (PPp + 16 // itemsize), n * rows, tile * (N + 1) * d,
              tile * (N + 1) * d, tile, n * (N + 1) * N, n * (N + 1) * d, N, q, d)
    return (sum(_a16(x * cov_itemsize) for x in covs)
            + sum(_a16(x * itemsize) for x in floats)
            + _a16(2 * PP) + _a16(4 * d) + _a16(4 * tile) + 32)


def sym_smem_bytes(tile, n, N, d, q, itemsize, tier="exact",
                   stages=_STAGES, cov_itemsize=8, cluster=0) -> int:
    """Shared memory of one block of the packed kernel with ``tile``
    profiles. The exact tier (``sym_layout`` in ``csrc/kalman_sym.cu``),
    with ``itemsize``-byte operators and means and a ``cov_itemsize``-byte
    covariance: two packed covariance buffers of ``tile * q`` columns
    (stride ``PPp`` plus one 16-byte vector) and ``Cw`` and ``1/S`` per
    column in the covariance's type; two ``P_s`` slabs for each of the n
    states,
    two mean buffers, ``Cw`` and ``1/S`` per column, the log-likelihoods,
    the mean operators ``Ballw, Gsw``, ``w``, ``s2``, one frame's data, the
    packed index table, ``Cind``, the column lists and two slab barriers.
    The split tiers (``split_layout`` in ``csrc/kalman_sym_split.cu``,
    float32): the ring of ``stages`` operator stages (a hi and a lo tile of
    ``_MB x _DEPTH`` bf16 each), one float32 covariance buffer (stride
    `split_ld`), the columns' bf16 pairs (hi and lo, ``8 x`` the most tiles
    of 8 the states can take, ``(tile q + 7 n) // 8``, by the depth padded
    to whole stages), then as the exact tier, with the S row of ``U1`` for
    'split', the indices of w's nonzero entries (and the S row's, for
    'split') and a full and an empty barrier per stage. With ``cluster``
    blocks per cluster (the exact tier's cluster plan): one block of that
    cluster (`_cluster_smem`); ``tile`` profiles per cluster."""
    if cluster:
        return _cluster_smem(tile, n, N, d, q, itemsize, cluster, cov_itemsize)
    PP = N * (N + 1) // 2
    PPp = _pad(PP, 8)
    ncol = tile * q
    if tier != "exact":
        KP = _pad(PPp, _DEPTH)
        nct = (ncol + 7 * n) // 8
        parts = (4 * ncol * split_ld(PPp), 8 * nct * KP * 4,
                 4 * tile * (N + 1) * d, 4 * tile * (N + 1) * d, 4 * ncol * N,
                 4 * ncol, 4 * tile, 4 * n * (N + 1) * N, 4 * n * (N + 1) * d,
                 4 * N, 4 * q, 4 * d, 2 * PP, 4 * PPp if tier == "split" else 0,
                 4 * (N + (PPp if tier == "split" else 0)), 4 * d, 4 * 8 * nct,
                 4 * nct, 4 * tile, 16, 16 * stages)
        return stages * _MB * _DEPTH * 4 + sum(_a16(x) for x in parts)
    ld = PPp + 16 // cov_itemsize
    nct = -(-ncol // _TN) + n
    slab = 2 * n * min(PPp, _ROWS_MAX) * _BK * itemsize
    covs = (ncol * ld, ncol * ld, ncol * N, ncol)
    floats = (tile * (N + 1) * d, tile * (N + 1) * d, tile, n * (N + 1) * N,
              n * (N + 1) * d, N, q, d)
    ints = (d, nct * _TN, nct, tile)
    return (sum(_a16(x * cov_itemsize) for x in covs)
            + sum(_a16(x * itemsize) for x in floats) + _a16(slab)
            + _a16(2 * PP) + sum(_a16(4 * x) for x in ints) + 16 + 16)


def _tile_fits(tile, n, N, d, q, itemsize, tier="exact", cov_itemsize=8):
    if tier == "exact":
        cols = -(-tile * q // _TN) + n <= SYM_THREADS
    else:
        cols = itemsize == 4 and tile * q <= _SPLIT_COLS
    return (sym_smem_bytes(tile, n, N, d, q, itemsize, tier,
                           cov_itemsize=cov_itemsize) <= SMEM_LIMIT and cols)


def sym_fits(n, N, d, q, itemsize, tier="exact") -> bool:
    """Whether the packed kernel takes this shape in this tier (else: the
    dense one)."""
    PPp = _pad(N * (N + 1) // 2, 8)
    return (n * PPp * PPp * itemsize <= SYM_OPERATOR_BUDGET and d <= _MAX_D
            and _tile_fits(SYM_TILES[-1], n, N, d, q, itemsize, tier))


@dataclasses.dataclass(frozen=True)
class SymPlan:
    """One launch of the packed kernel: ``tile`` profiles per block (per
    cluster in the cluster plan), ``tiles_per_lane`` blocks (clusters) per
    lane, ``blocks`` in all; the split tiers' ring of ``stages`` operator
    stages (0 in the exact tier); ``cluster`` blocks per cluster in the
    exact tier's cluster plan (0: the tile plan)."""

    tile: int
    tiles_per_lane: int
    blocks: int
    smem: int
    stages: int = 0
    cluster: int = 0


def _cluster_plan(L, P, n, N, d, q, itemsize, slots, sizes=SYM_CLUSTERS):
    """The cluster plan of an ``(L, P)`` launch, or None where no cluster
    size of ``sizes`` that the device holds (``slots(C)`` clusters at
    once) fits one profile per cluster into shared memory. For the first
    that fits: as few profiles per cluster (at most ``SYM_TILES[0]``) as
    let the launch's clusters run at once, fewer if those do not fit."""
    for C in sizes:
        held = slots(C)
        if held < 1 or _cluster_smem(1, n, N, d, q, itemsize, C) > SMEM_LIMIT:
            continue
        tile = min(SYM_TILES[0], -(-P // max(1, held // L)))
        while _cluster_smem(tile, n, N, d, q, itemsize, C) > SMEM_LIMIT:
            tile -= 1
        per_lane = -(-P // tile)
        return SymPlan(tile, per_lane, L * per_lane * C,
                       _cluster_smem(tile, n, N, d, q, itemsize, C), cluster=C)
    return None


def sym_plan(L, P, n, N, d, q, itemsize, sms=H100_SMS,
             tier="exact", cov_itemsize=8, cluster_slots=None,
             _force=None) -> SymPlan:
    """
    The plan of an ``(L, P)`` launch in ``tier`` (the exact tier with a
    ``cov_itemsize``-byte covariance: 8, float64, in this kernel; 4 gives
    the layout and plan of its float32-covariance predecessor).

    The tile plan: the widest tile (of `SYM_TILES`) that fits
    `SMEM_LIMIT`, keeps two blocks resident per SM and still gives every
    SM two blocks, where the kernel holds two blocks per SM (the split
    tiers; a float32 covariance); else the widest that gives every SM one
    block; else the narrowest, one profile per block. The exact tier's
    float64 covariance takes the registers of a second block, so it is
    planned for one. The split tiers then take the deepest operator ring
    (up to `_MAX_STAGES`) that keeps two blocks per SM where the tile was
    chosen for two, else that fits `SMEM_LIMIT`.

    The cluster plan (the exact tier with its float64 covariance), where
    even one profile per block leaves SMs idle (``L * P < sms``, as a
    single-trajectory `sample()` step, L=1, P=100) and a cluster's
    operator rows fit beside its replicas (`_cluster_plan`): clusters of
    C blocks keep every state's operators resident and stream the
    profiles. ``cluster_slots(C)`` is the number of clusters of C blocks
    the device holds at once (cudaOccupancyMaxActiveClusters; default
    `H100_CLUSTER_SLOTS`). ``_force`` (``"tile"``, ``"cluster"`` or a
    cluster size; for tests and the smoke script only) takes that plan
    wherever it fits. Raises for shapes that `sym_fits` refuses.
    """
    fits = [t for t in SYM_TILES
            if _tile_fits(t, n, N, d, q, itemsize, tier, cov_itemsize)]
    if not fits:
        raise ValueError(f"packed kernel does not fit n={n}, N={N}, d={d}, "
                         f"q={q}, {itemsize}-byte floats, tier {tier!r}")

    def blocks(t):
        return L * -(-P // t)

    def smem(t):
        return sym_smem_bytes(t, n, N, d, q, itemsize, tier,
                              cov_itemsize=cov_itemsize)

    two_per_sm = tier != "exact" or cov_itemsize == 4
    two = [t for t in fits if two_per_sm and 2 * (smem(t) + 1024) <= SMEM_PER_SM
           and blocks(t) >= 2 * sms]
    one = [t for t in fits if blocks(t) >= sms]
    chosen = (two or one or fits[-1:])[0]
    if tier == "exact":
        if not two_per_sm and _force != "tile" and (
                _force is not None or blocks(chosen) < sms):
            plan = _cluster_plan(
                L, P, n, N, d, q, itemsize,
                cluster_slots or (lambda C: H100_CLUSTER_SLOTS.get(C, 0)),
                (_force,) if isinstance(_force, int) else SYM_CLUSTERS)
            if plan is not None:
                return plan
            if _force is not None:
                raise ValueError(f"no cluster plan fits n={n}, N={N}, d={d}, "
                                 f"q={q}, {itemsize}-byte floats")
        return SymPlan(chosen, -(-P // chosen), blocks(chosen), smem(chosen))
    # the split tiers: the deepest ring that keeps the blocks per SM
    budget = SMEM_PER_SM // 2 - 1024 if two else SMEM_LIMIT
    stages = _STAGES
    while (stages < _MAX_STAGES and sym_smem_bytes(
            chosen, n, N, d, q, itemsize, tier, stages + 1) <= budget):
        stages += 1
    return SymPlan(chosen, -(-P // chosen), blocks(chosen),
                   sym_smem_bytes(chosen, n, N, d, q, itemsize, tier, stages),
                   stages)


def auto_kernel(L, P, n, N, d, q, itemsize, tier="exact", sms=H100_SMS) -> str:
    """
    The kernel of an ``(L, P)`` launch under the ``'auto'`` selector
    (`config.set_rouse_kernel`): ``'sym'`` (`msrouse_logL_sym`) or
    ``'dense'`` (`ops.kalman_dense.msrouse_logL_dense`), from host integers
    alone (nothing is read from the device, so a step graph's capture
    sees no difference). ``tier`` is the resolved matmul tier.

    ``'sym'`` where the tier is a split one (the dense kernel has none);
    where the dense kernel would carry a float32 covariance
    (`dense_cov_itemsize`; the packed kernel then runs as under ``'sym'``);
    and where the packed kernel takes its cluster plan, i.e. where the
    launch cannot fill the ``sms`` SMs (``L P < sms``; `sample()`'s step,
    L=1, P=100, where the cluster plan beats one warp per profile).
    ``'dense'`` everywhere else: its work grows as N^3 against the packed
    kernel's N^4, and it is the faster where a launch fills the card (at
    every dataset runner's launch shape on an H100). Shapes the packed
    kernel does not take (`sym_fits`) go to the dense kernel either way.
    """
    if tier != "exact" or dense_cov_itemsize(n, N, d, q, itemsize) < 8:
        return "sym"
    if sym_fits(n, N, d, q, itemsize) and sym_plan(
            L, P, n, N, d, q, itemsize, sms=sms).cluster:
        return "sym"
    return "dense"


def build_sym_operators(Bs, Gs, Sigs, M0s, C0s, w, pad=8):
    """
    Host (numpy float64) construction of the packed-space operators, the
    same arrays as `bild_tpu.ops.kalman_sym._build_sym_operators`:
    ``(Pall (n*PPp, PPp), sig_pack (n, PPp), c0_pack (n, PPp),
    U1 (S_OFF+pad, PPp), Ballw (n*N1p, N), Gsw (n, N1p, d),
    M0w (n, N1p, d), PPp, (S_OFF, N1p))``. Zero padding is exact.
    """
    Bs, Gs, Sigs, M0s, C0s, w = (np.asarray(x, dtype=np.float64)
                                 for x in (Bs, Gs, Sigs, M0s, C0s, w))
    n, N, _ = Bs.shape
    d = Gs.shape[2]
    ia, ja = np.triu_indices(N)
    PP = len(ia)
    PPp = _pad(PP, pad)

    off_diag = (ia != ja).astype(np.float64)
    P_ops = np.zeros((n, PPp, PPp))
    for s in range(n):
        B = Bs[s]
        P_ops[s, :PP, :PP] = (B[ia][:, None, ia] * B[ja][:, None, ja]
                              + (B[ia][:, None, ja] * B[ja][:, None, ia])
                              * off_diag[None, None, :])[:, 0, :]
    Pall = P_ops.reshape(n * PPp, PPp)

    sig_pack = np.zeros((n, PPp))
    c0_pack = np.zeros((n, PPp))
    sig_pack[:, :PP] = Sigs[:, ia, ja]
    c0_pack[:, :PP] = C0s[:, ia, ja]

    Gw = np.zeros((N, PPp))
    for p in range(PP):
        a, b = ia[p], ja[p]
        Gw[a, p] += w[b]
        if a != b:
            Gw[b, p] += w[a]

    S_OFF = _pad(N, pad)
    U1 = np.zeros((S_OFF + pad, PPp))
    U1[:N] = Gw
    U1[S_OFF] = w @ Gw

    N1p = _pad(N + 1, pad)
    Ballw = np.zeros((n * N1p, N))
    Gsw = np.zeros((n, N1p, d))
    M0w = np.zeros((n, N1p, d))
    for s in range(n):
        Ballw[s * N1p:s * N1p + N] = Bs[s]
        Ballw[s * N1p + N] = w @ Bs[s]
        Gsw[s, :N] = Gs[s]
        Gsw[s, N] = w @ Gs[s]
        M0w[s, :N] = M0s[s]
        M0w[s, N] = w @ M0s[s]
    return (Pall, sig_pack, c0_pack, U1, Ballw, Gsw, M0w, PPp, (S_OFF, N1p))


def slab_operators(Pall, n, PPp, itemsize):
    """``Pall (n*PPp, PPp)`` in the order the kernel streams it: per state,
    per slab of 8 operator columns, the PPp rows of 8 scalars each
    contiguous, ``(n, PPp/8, PPp, 8)``, so that one bulk copy moves one
    slab; within a row, 16-byte chunk ch of row r sits at chunk ``ch ^ ((r
    // (8 // CH)) % CH)`` (CH chunks per row), the kernel's bank swizzle."""
    CH = _BK * itemsize // 16
    vw = _BK // CH
    nkb = PPp // _BK
    A = np.asarray(Pall).reshape(n, PPp, nkb, CH, vw)
    r = np.arange(PPp)
    out = np.zeros((n, nkb, PPp, CH, vw), dtype=A.dtype)
    for ch in range(CH):
        dest = ch ^ ((r // (8 // CH)) % CH)
        out[:, :, r, dest, :] = A[:, :, :, ch, :].transpose(0, 2, 1, 3)
    return out.reshape(n, nkb, PPp, _BK)


def row_operators(Pall, n, PPp, itemsize):
    """``Pall (n*PPp, PPp)`` as the cluster plan loads it, ``(n, PPp,
    PPp + 16 // itemsize)``: each row padded with zeros to a whole 16-byte
    vector of ``itemsize``-byte scalars, so that a block's rows of one
    state are one bulk copy and the rows that neighbouring threads read
    fall in distinct bank groups."""
    out = np.zeros((n, PPp, PPp + 16 // itemsize))
    out[:, :, :PPp] = np.asarray(Pall).reshape(n, PPp, PPp)
    return out


def hi_lo(x: torch.Tensor):
    """The bfloat16 pair of a float32 tensor: ``hi = bf16(x)``, ``lo =
    bf16(x - hi)``, each rounded to nearest even (``x - hi`` is exact);
    ``hi + lo`` carries 16 bits of x's 24."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def split_product(product, a_pair, x):
    """``product(a, x)`` in the split tier: ``a`` given as its bf16 pair,
    ``x`` split here, three products of exactly representable operands in
    ``x``'s float type, summed as the reference sums them,
    ``(a_hi x_hi + a_hi x_lo) + a_lo x_hi``."""
    a_hi, a_lo = (v.to(x.dtype) for v in a_pair)
    x_hi, x_lo = (v.to(x.dtype) for v in hi_lo(x))
    return product(a_hi, x_hi) + product(a_hi, x_lo) + product(a_lo, x_hi)


def split_stages(Pall, n, PPp) -> np.ndarray:
    """The split tiers' propagators in the order the kernel streams them,
    ``(n, 2 KP^2)`` int16 (bfloat16 bits; ``KP`` = PPp padded to whole
    stages of ``_DEPTH``, rows and columns padded with zeros). Per state,
    per m-block of ``_MB`` rows (the last one ``KP - _MB mb`` rows), per
    stage of ``_DEPTH`` operator columns: the hi tile, then the lo tile,
    each ``rows x _DEPTH`` in wgmma's K-major core matrices without
    swizzle, core matrix (8 rows x 8 columns, 128 contiguous bytes) ``(rg,
    kg)`` at ``rg * _DEPTH / 8 + kg``, row-major inside. ``Pall`` is split
    from float32 (`hi_lo`)."""
    KP = _pad(PPp, _DEPTH)
    A = torch.as_tensor(np.asarray(Pall).reshape(n, PPp, PPp),
                        dtype=torch.float32)
    full = np.zeros((2, n, KP, KP), dtype=np.int16)
    for i, half in enumerate(hi_lo(A)):
        full[i, :, :PPp, :PPp] = half.view(torch.int16).numpy()
    stream = []
    for r0 in range(0, KP, _MB):
        rows = min(_MB, KP - r0)
        for k0 in range(0, KP, _DEPTH):
            tile = full[:, :, r0:r0 + rows, k0:k0 + _DEPTH]
            cores = tile.reshape(2, n, rows // 8, 8, _DEPTH // 8, 8)
            stream.append(cores.transpose(1, 0, 2, 4, 3, 5).reshape(n, -1))
    return np.ascontiguousarray(np.concatenate(stream, axis=1))


@dataclasses.dataclass(frozen=True)
class SymOperators:
    """The packed operators as tensors of one dtype on one device. The
    CUDA kernel reads ``Pslab``, the propagators in its tile plan's order
    (`slab_operators`), and ``Prow`` in its cluster plan's
    (`row_operators`), both built for a CUDA device only; the split tiers'
    kernel reads ``Psplit`` and ``Srow``. The plain version reads ``Pall`` and ``U1``,
    made on the device from the float64 host arrays ``host`` when it
    first runs, and in a split tier ``pairs``."""

    sig: torch.Tensor
    c0: torch.Tensor
    Ballw: torch.Tensor
    Gsw: torch.Tensor
    M0w: torch.Tensor
    Pslab: torch.Tensor | None
    Prow: torch.Tensor | None
    host: tuple = dataclasses.field(repr=False)    # (Pall, U1), numpy
    PPp: int
    S_OFF: int
    N1p: int

    @staticmethod
    def build(Bs, Gs, Sigs, M0s, C0s, w, *, device, dtype) -> "SymOperators":
        """Build from model arrays (numpy or tensors; computed in float64)."""
        host = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
                for x in (Bs, Gs, Sigs, M0s, C0s, w)]
        (Pall, sig, c0, U1, Ballw, Gsw, M0w, PPp,
         (S_OFF, N1p)) = build_sym_operators(*host)
        n = sig.shape[0]

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        itemsize = torch.empty((), dtype=dtype).element_size()
        cuda = torch.device(device).type == "cuda"
        Pslab = dev(slab_operators(Pall, n, PPp, itemsize)) if cuda else None
        Prow = dev(row_operators(Pall, n, PPp, itemsize)) if cuda else None
        return SymOperators(dev(sig), dev(c0), dev(Ballw), dev(Gsw), dev(M0w),
                            Pslab, Prow, (Pall, U1), PPp=PPp, S_OFF=S_OFF,
                            N1p=N1p)

    @functools.cached_property
    def Pall(self) -> torch.Tensor:
        return torch.as_tensor(self.host[0], dtype=self.sig.dtype,
                               device=self.sig.device)

    @functools.cached_property
    def U1(self) -> torch.Tensor:
        return torch.as_tensor(self.host[1], dtype=self.sig.dtype,
                               device=self.sig.device)

    @functools.cached_property
    def pairs(self) -> dict:
        """``{"Pall", "U1", "Ballw": (hi, lo)}``: the bfloat16 pairs
        (`hi_lo`) of the float32-rounded operators, as the reference
        kernel splits its float32 operator refs."""
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=self.sig.device)

        return {"Pall": hi_lo(f32(self.host[0])), "U1": hi_lo(f32(self.host[1])),
                "Ballw": hi_lo(self.Ballw.to(torch.float32))}

    @functools.cached_property
    def Psplit(self) -> torch.Tensor:
        """The split tiers' propagators in the kernel's order
        (`split_stages`), on the operators' device."""
        return torch.as_tensor(split_stages(self.host[0], self.n, self.PPp),
                               device=self.sig.device)

    @functools.cached_property
    def Srow(self) -> torch.Tensor:
        """Row ``S_OFF`` of ``U1`` in float32 (``S = Srow.c``): the split
        tier's kernel splits it as the reference splits ``U1``."""
        return torch.as_tensor(self.host[1][self.S_OFF], dtype=torch.float32,
                               device=self.sig.device)

    @property
    def n(self) -> int:
        return self.sig.shape[0]

    @property
    def N(self) -> int:
        return self.Ballw.shape[1]


def update_contraction(ops: SymOperators, c, s2, split=False):
    """The update contraction ``R1 = U1 c`` of packed covariances ``c``
    (..., q, PPp): ``(Cw (..., q, N), Sinv (..., q))``, ``Sinv = 1 / (S +
    s2)``, in ``c``'s type (``U1`` converted exactly); ``split``: each
    product split (`split_product`), 'split''s."""
    if split:
        R1 = split_product(lambda a, v: v @ a.T, ops.pairs["U1"], c)
    else:
        R1 = c @ ops.U1.to(c.dtype).T
    return R1[..., :ops.N], 1.0 / (R1[..., ops.S_OFF] + s2)


def mean_propagation(ops: SymOperators, M, st, split=False):
    """``Ballw_s M + Gsw_s`` for means ``M`` (R, N1p or N + 1, d) in states
    ``st`` (R,): (R, N1p, d); ``split``: each product split, 'split''s."""
    Mt = M[:, :ops.N]
    if split:
        BM = split_product(lambda a, v: torch.einsum("rk,pkd->prd", a, v),
                           ops.pairs["Ballw"], Mt)
    else:
        BM = torch.einsum("rk,pkd->prd", ops.Ballw, Mt)
    rows = torch.arange(M.shape[0], device=M.device)
    return BM.view(M.shape[0], ops.n, ops.N1p, -1)[rows, st] + ops.Gsw[st]


def msrouse_logL_sym_torch(ops: SymOperators, s2, Cind, profiles, ydata,
                           valid, matmul="exact"):
    """Plain PyTorch version of the packed kernel: the same algorithm on
    the same operators, every profile of every lane in one tensor. Shapes
    as `ops.kalman.msrouse_logL_batch` (lane or single-lane form).
    ``matmul`` is the tier (`check_tier`; inert unless ``ydata`` is
    float32): the split products are `split_product` on the operators'
    `pairs`. The exact tier carries ``c``, ``Cw``, ``1/S`` and the
    downdate in float64, the operators converted exactly at use; ``K``
    and ``1/S`` are rounded once to the inputs' type for the means and the
    log-density. The split tiers carry them in the inputs' type."""
    matmul = check_tier(matmul)
    msrouse_logL_sym_torch.calls += 1
    split_cov = matmul != "exact" and ydata.dtype == torch.float32
    return _sym_recursion(ops, s2, Cind, profiles, ydata, valid, split_cov,
                          split_cov and matmul == "split",
                          ydata.dtype if split_cov else torch.float64)


def _sym_recursion(ops, s2, Cind, profiles, ydata, valid, split_cov,
                   split_upd, cov):
    """`msrouse_logL_sym_torch`'s recursion: the conjugation split
    (``split_cov``) or not, the update contraction and the means split
    (``split_upd``) or not, the covariance carried in ``cov``."""
    profiles, ydata, valid, single = as_lanes(profiles, ydata, valid)
    n, N, PPp = ops.n, ops.N, ops.PPp
    L, P, T = profiles.shape
    R = L * P
    q = s2.shape[0]
    dev = ydata.device
    Cind = torch.as_tensor(Cind, dtype=torch.long, device=dev)
    prof = profiles.reshape(R, T).long().clamp(0, n - 1)
    lane = torch.arange(R, device=dev) // P                # row -> lane
    ia, ja = (torch.as_tensor(i, device=dev) for i in np.triu_indices(N))

    Pall, sig = (None if split_cov else ops.Pall.to(cov)), ops.sig.to(cov)
    st0 = prof[:, 0]
    c = ops.c0.to(cov)[st0][:, None, :].expand(R, q, PPp)  # (R, q, PPp)
    M = ops.M0w[st0]                                       # (R, N1p, d)
    acc = torch.zeros((R,), dtype=ydata.dtype, device=dev)

    def observe(t, c, M, acc):
        y = ydata[lane, t]                                 # (R, d)
        Cw, Sinv = update_contraction(ops, c, s2, split_upd)  # (R, q, N), (R, q)
        upd = torch.zeros_like(c)
        upd[..., :len(ia)] = Cw[..., ia] * Cw[..., ja]
        c_u = c - upd * Sinv[..., None]
        K = (Cw * Sinv[..., None]).to(ydata.dtype)         # (R, q, N)
        Sinv = Sinv.to(ydata.dtype)
        xmm = y - M[:, N, :]                               # (R, d)
        M_top = M[:, :N] + K[:, Cind].transpose(1, 2) * xmm[:, None, :]
        M_u = torch.cat([M_top, M[:, N:]], dim=1)
        Sd = Sinv[:, Cind]                                 # (R, d)
        ll = (-0.5 * (xmm * xmm * Sd - torch.log(Sd) + LOG_2PI)).sum(dim=1)
        v = valid[lane, t]                                 # (R,)
        return (torch.where(v[:, None, None], c_u, c),
                torch.where(v[:, None, None], M_u, M),
                acc + torch.where(v, ll, 0.0))

    c, M, acc = observe(0, c, M, acc)
    rows = torch.arange(R, device=dev)
    for t in range(1, T):
        st = prof[:, t]
        if split_cov:                                      # every state
            Pc = split_product(lambda a, v: v @ a.T, ops.pairs["Pall"], c)
        else:
            Pc = c @ Pall.T
        c = Pc.view(R, q, n, PPp)[rows, :, st] + sig[st][:, None, :]
        M = mean_propagation(ops, M, st, split_upd)
        c, M, acc = observe(t, c, M, acc)

    acc = acc.view(L, P)
    out = torch.where(in_range_mask(profiles, n), acc,
                      torch.full_like(acc, math.nan))
    return out[0] if single else out


counters.register("plain_sym", msrouse_logL_sym_torch, "calls")


@functools.cache
def _cluster_slots(sfx, index, C) -> int:
    """Clusters of ``C`` blocks of the cluster kernel (``sfx`` its build)
    that CUDA device ``index`` holds at once, asked once per device, build
    and size (cudaOccupancyMaxActiveClusters)."""
    lib = _build.load("kalman_sym")
    fn = getattr(lib, f"bild_kalman_sym_cluster_slots_{sfx}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    held = fn(C, index)
    if held < 0:
        _build.check(lib, -held, f"cluster occupancy of {C} blocks")
    return held


def msrouse_logL_sym(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata,
                     valid, ops: SymOperators | None = None, matmul=None,
                     _force=None):
    """
    Log-likelihoods, arguments and shapes as `ops.kalman.msrouse_logL_batch`
    (``(L, P)`` for L lanes, ``(P,)`` for the single-lane form), plus the
    prebuilt packed operators ``ops`` (built here if omitted; models pass
    theirs, built once in float64) and the matmul tier ``matmul``
    (`check_tier`: None is `config.resolve_matmul("single")`; float64
    computes every tier exactly). Shapes that `sym_fits` refuses go to
    the dense kernel, which is always exact. CUDA tensors launch the
    kernel on the current stream (no synchronization) with `sym_plan`'s
    plan: one block per tile of profiles of one lane, or, where that
    leaves SMs idle, clusters that keep the operators resident (counted
    in ``msrouse_logL_sym.cluster_launches``; a refused cluster launch
    raises); CPU tensors run `msrouse_logL_sym_torch`. Out-of-range
    states give NaN. ``_force`` is `sym_plan`'s, for tests.
    """
    n, N, _ = Bs.shape
    d = Gs.shape[2]
    q = s2.shape[0]
    tier = check_tier(matmul)
    if ydata.dtype != torch.float32:
        tier = "exact"                 # the split tiers are float32 only
    if not sym_fits(n, N, d, q, ydata.element_size(), tier):
        return msrouse_logL_dense(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                                  profiles, ydata, valid)
    if ops is None:
        ops = SymOperators.build(Bs, Gs, Sigs, M0s, C0s, w,
                                 device=ydata.device, dtype=ydata.dtype)
    if ydata.device.type == "cpu":
        return msrouse_logL_sym_torch(ops, s2, Cind, profiles, ydata, valid,
                                      matmul=tier)
    if ydata.device.type != "cuda":
        raise ValueError(f"no kernel for device {ydata.device}")
    profiles, ydata, valid, single = as_lanes(profiles, ydata, valid)
    if ops.Pslab is None:
        raise ValueError(f"packed operators built for {ops.sig.device}, "
                         f"not for {ydata.device}")
    sfx = check_cuda_args(dict(Pslab=ops.Pslab, sig=ops.sig, c0=ops.c0,
                               w=w, Ballw=ops.Ballw, Gsw=ops.Gsw,
                               M0w=ops.M0w, s2=s2, ydata=ydata),
                          profiles, ydata, valid)
    if ops.n != n or ops.N != N or ops.Gsw.shape[2] != d or w.shape != (N,) \
            or ydata.shape[2] != d:
        raise ValueError("packed operators do not match the model shapes")
    Cind = cind_tensor(Cind, d, ydata.device)
    L, P, T = profiles.shape
    index = ydata.device.index or 0
    plan = sym_plan(L, P, n, N, d, q, ydata.element_size(),
                    sms=sm_count(index), tier=tier,
                    cluster_slots=functools.partial(_cluster_slots, sfx, index),
                    _force=_force)
    out = torch.empty((L, P), dtype=ydata.dtype, device=ydata.device)
    if L * P > 0:
        if plan.cluster:
            lib, fn = _build.entry("kalman_sym", f"bild_kalman_sym_cluster_{sfx}",
                                   13, 13)
            ptrs, ints = (ops.Prow.data_ptr(),), (plan.cluster,)
        elif tier == "exact":
            lib, fn = _build.entry("kalman_sym", f"bild_kalman_sym_{sfx}", 13, 12)
            ptrs, ints = (ops.Pslab.data_ptr(),), ()
        else:
            name = "split" if tier == "split" else "splitcov"
            lib, fn = _build.entry("kalman_sym_split",
                                   f"bild_kalman_sym_{name}_f32", 14, 13)
            ptrs = (ops.Psplit.data_ptr(), ops.Srow.data_ptr())
            ints = (plan.stages,)
        rc = fn(*ptrs, ops.sig.data_ptr(), ops.c0.data_ptr(),
                w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
                ops.M0w.data_ptr(), s2.data_ptr(), Cind.data_ptr(),
                profiles.data_ptr(), ydata.data_ptr(), valid.data_ptr(),
                out.data_ptr(), n, N, d, q, L, P, T, ops.PPp, ops.N1p,
                plan.tile, *ints, plan.smem, index,
                torch.cuda.current_stream(ydata.device).cuda_stream)
        msrouse_logL_sym.launches += 1
        if tier != "exact":
            msrouse_logL_sym.split_launches += 1
        if plan.cluster:
            msrouse_logL_sym.cluster_launches += 1
        _build.check(lib, rc, "kalman_sym launch")
        out = torch.where(in_range_mask(profiles, n), out,
                          torch.full_like(out, math.nan))
    return out[0] if single else out


counters.register("kalman_sym", msrouse_logL_sym, "launches")
counters.register("kalman_sym_split", msrouse_logL_sym, "split_launches")
counters.register("kalman_sym_cluster", msrouse_logL_sym, "cluster_launches")
