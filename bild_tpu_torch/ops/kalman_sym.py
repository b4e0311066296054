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

On the H100 one block evaluates a tile of up to 32 profiles of one lane
(trajectory), so one launch covers a whole lockstep AMIS step. Per frame
the block sorts its profiles by state and multiplies each state's ``P_s``
(streamed from L2 in slabs) into all of that state's packed covariances
at once (see the source). `sym_plan` chooses the tile width and the
shared memory from the launch's shape. Operators larger than
`SYM_OPERATOR_BUDGET` would no longer stay in L2, and the dense kernel
needs only ``n N^2`` operator scalars: above it the wrapper calls
`ops.kalman_dense.msrouse_logL_dense`, as the reference falls back from
its packed kernel to its dense one.

`msrouse_logL_sym` launches the kernel for CUDA tensors and runs
`msrouse_logL_sym_torch` for CPU tensors, with no fallback between them.
Counters: ``msrouse_logL_sym.launches``, ``msrouse_logL_sym_torch.calls``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import _build
from .kalman import LOG_2PI, as_lanes, in_range_mask
from .kalman_dense import (H100_SMS, SMEM_LIMIT, SMEM_PER_SM,
                           check_cuda_args, cind_tensor, msrouse_logL_dense,
                           sm_count)

__all__ = ["SymOperators", "build_sym_operators", "msrouse_logL_sym",
           "msrouse_logL_sym_torch", "sym_fits", "sym_plan", "SymPlan",
           "sym_smem_bytes", "SYM_OPERATOR_BUDGET", "SYM_TILES"]

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


def _a16(nbytes):
    return -(-nbytes // 16) * 16


def sym_smem_bytes(tile, n, N, d, q, itemsize) -> int:
    """Shared memory of one block of the packed kernel with ``tile``
    profiles (``sym_layout`` in ``csrc/kalman_sym.cu``): two packed
    covariance buffers of ``tile * q`` columns (stride ``PPp`` plus one
    16-byte vector), two ``P_s`` slabs for each of the n states,
    two mean buffers, ``Cw`` and ``1/S`` per column, the log-likelihoods,
    the mean operators ``Ballw, Gsw``, ``w``, ``s2``, one frame's data,
    the packed index table, ``Cind``, the column lists and two slab
    barriers."""
    PP = N * (N + 1) // 2
    PPp = _pad(PP, 8)
    ld = PPp + 16 // itemsize
    ncol = tile * q
    nct = -(-ncol // _TN) + n
    rows_slab = min(PPp, _ROWS_MAX)
    floats = (ncol * ld, ncol * ld, 2 * n * rows_slab * _BK,
              tile * (N + 1) * d, tile * (N + 1) * d, ncol * N, ncol, tile,
              n * (N + 1) * N, n * (N + 1) * d, N, q, d)
    ints = (d, nct * _TN, nct, tile)
    return (sum(_a16(x * itemsize) for x in floats) + _a16(2 * PP)
            + sum(_a16(4 * x) for x in ints) + 16 + 16)


def _tile_fits(tile, n, N, d, q, itemsize):
    return (sym_smem_bytes(tile, n, N, d, q, itemsize) <= SMEM_LIMIT
            and -(-tile * q // _TN) + n <= SYM_THREADS)


def sym_fits(n, N, d, q, itemsize) -> bool:
    """Whether the packed kernel takes this shape (else: the dense one)."""
    PPp = _pad(N * (N + 1) // 2, 8)
    return (n * PPp * PPp * itemsize <= SYM_OPERATOR_BUDGET and d <= _MAX_D
            and _tile_fits(SYM_TILES[-1], n, N, d, q, itemsize))


@dataclasses.dataclass(frozen=True)
class SymPlan:
    """One launch of the packed kernel: ``tile`` profiles per block."""

    tile: int
    tiles_per_lane: int
    blocks: int
    smem: int


def sym_plan(L, P, n, N, d, q, itemsize, sms=H100_SMS) -> SymPlan:
    """
    Tile width for an ``(L, P)`` launch. The widest tile (of `SYM_TILES`)
    that fits `SMEM_LIMIT`, keeps two blocks resident per SM and still
    gives every SM two blocks; else the widest that gives every SM one
    block; else the narrowest, so that a single-trajectory step (L=1,
    P=100) spreads over as many SMs as it has profiles. Raises for shapes
    that `sym_fits` refuses.
    """
    fits = [t for t in SYM_TILES if _tile_fits(t, n, N, d, q, itemsize)]
    if not fits:
        raise ValueError(f"packed kernel does not fit n={n}, N={N}, d={d}, "
                         f"q={q}, {itemsize}-byte floats")

    def blocks(t):
        return L * -(-P // t)

    def smem(t):
        return sym_smem_bytes(t, n, N, d, q, itemsize)

    two = [t for t in fits if 2 * (smem(t) + 1024) <= SMEM_PER_SM
           and blocks(t) >= 2 * sms]
    one = [t for t in fits if blocks(t) >= sms]
    chosen = (two or one or fits[-1:])[0]
    return SymPlan(chosen, -(-P // chosen), blocks(chosen), smem(chosen))


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


@dataclasses.dataclass(frozen=True)
class SymOperators:
    """The packed operators as tensors of one dtype on one device. The
    CUDA kernel reads ``Pslab``, the propagators in its order
    (`slab_operators`; built for a CUDA device only). The plain version
    reads ``Pall`` and ``U1``, made on the device from the float64 host
    arrays ``host`` when it first runs."""

    sig: torch.Tensor
    c0: torch.Tensor
    Ballw: torch.Tensor
    Gsw: torch.Tensor
    M0w: torch.Tensor
    Pslab: torch.Tensor | None
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

        Pslab = (dev(slab_operators(Pall, n, PPp,
                                    torch.empty((), dtype=dtype).element_size()))
                 if torch.device(device).type == "cuda" else None)
        return SymOperators(dev(sig), dev(c0), dev(Ballw), dev(Gsw), dev(M0w),
                            Pslab, (Pall, U1), PPp=PPp, S_OFF=S_OFF, N1p=N1p)

    @functools.cached_property
    def Pall(self) -> torch.Tensor:
        return torch.as_tensor(self.host[0], dtype=self.sig.dtype,
                               device=self.sig.device)

    @functools.cached_property
    def U1(self) -> torch.Tensor:
        return torch.as_tensor(self.host[1], dtype=self.sig.dtype,
                               device=self.sig.device)

    @property
    def n(self) -> int:
        return self.sig.shape[0]

    @property
    def N(self) -> int:
        return self.Ballw.shape[1]


def msrouse_logL_sym_torch(ops: SymOperators, s2, Cind, profiles, ydata,
                           valid):
    """Plain PyTorch version of the packed kernel: the same algorithm on
    the same operators, every profile of every lane in one tensor. Shapes
    as `ops.kalman.msrouse_logL_batch` (lane or single-lane form)."""
    msrouse_logL_sym_torch.calls += 1
    profiles, ydata, valid, single = as_lanes(profiles, ydata, valid)
    n, N, PPp, S_OFF, N1p = ops.n, ops.N, ops.PPp, ops.S_OFF, ops.N1p
    L, P, T = profiles.shape
    R = L * P
    q = s2.shape[0]
    dev = ydata.device
    Cind = torch.as_tensor(Cind, dtype=torch.long, device=dev)
    prof = profiles.reshape(R, T).long().clamp(0, n - 1)
    lane = torch.arange(R, device=dev) // P                # row -> lane
    ia, ja = (torch.as_tensor(i, device=dev) for i in np.triu_indices(N))

    st0 = prof[:, 0]
    c = ops.c0[st0][:, None, :].expand(R, q, PPp)          # (R, q, PPp)
    M = ops.M0w[st0]                                       # (R, N1p, d)
    acc = torch.zeros((R,), dtype=ydata.dtype, device=dev)

    def observe(t, c, M, acc):
        y = ydata[lane, t]                                 # (R, d)
        R1 = c @ ops.U1.T                                  # (R, q, U1Rows)
        Sinv = 1.0 / (R1[..., S_OFF] + s2)                 # (R, q)
        Cw = R1[..., :N]                                   # (R, q, N)
        upd = torch.zeros_like(c)
        upd[..., :len(ia)] = Cw[..., ia] * Cw[..., ja]
        c_u = c - upd * Sinv[..., None]
        xmm = y - M[:, N, :]                               # (R, d)
        K = Cw * Sinv[..., None]                           # (R, q, N)
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
        Pc = (c @ ops.Pall.T).view(R, q, n, PPp)           # every state
        c = Pc[rows, :, st] + ops.sig[st][:, None, :]
        BM = torch.einsum("rk,pkd->prd", ops.Ballw, M[:, :N])
        M = BM.view(R, n, N1p, -1)[rows, st] + ops.Gsw[st]
        c, M, acc = observe(t, c, M, acc)

    acc = acc.view(L, P)
    out = torch.where(in_range_mask(profiles, n), acc,
                      torch.full_like(acc, math.nan))
    return out[0] if single else out


msrouse_logL_sym_torch.calls = 0


def msrouse_logL_sym(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata,
                     valid, ops: SymOperators | None = None):
    """
    Log-likelihoods, arguments and shapes as `ops.kalman.msrouse_logL_batch`
    (``(L, P)`` for L lanes, ``(P,)`` for the single-lane form), plus the
    prebuilt packed operators ``ops`` (built here if omitted; models pass
    theirs, built once in float64). Shapes that `sym_fits` refuses go to
    the dense kernel. CUDA tensors launch the kernel, one block per tile
    of profiles of one lane (the width from `sym_plan`), on the current
    stream (no synchronization); CPU tensors run
    `msrouse_logL_sym_torch`. Out-of-range states give NaN.
    """
    n, N, _ = Bs.shape
    d = Gs.shape[2]
    q = s2.shape[0]
    if not sym_fits(n, N, d, q, ydata.element_size()):
        return msrouse_logL_dense(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                                  profiles, ydata, valid)
    if ops is None:
        ops = SymOperators.build(Bs, Gs, Sigs, M0s, C0s, w,
                                 device=ydata.device, dtype=ydata.dtype)
    if ydata.device.type == "cpu":
        return msrouse_logL_sym_torch(ops, s2, Cind, profiles, ydata, valid)
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
                    sms=sm_count(index))
    out = torch.empty((L, P), dtype=ydata.dtype, device=ydata.device)
    if L * P > 0:
        lib, fn = _build.entry("kalman_sym", f"bild_kalman_sym_{sfx}", 13, 12)
        rc = fn(ops.Pslab.data_ptr(), ops.sig.data_ptr(), ops.c0.data_ptr(),
                w.data_ptr(), ops.Ballw.data_ptr(), ops.Gsw.data_ptr(),
                ops.M0w.data_ptr(), s2.data_ptr(), Cind.data_ptr(),
                profiles.data_ptr(), ydata.data_ptr(), valid.data_ptr(),
                out.data_ptr(), n, N, d, q, L, P, T, ops.PPp, ops.N1p,
                plan.tile, plan.smem, index,
                torch.cuda.current_stream(ydata.device).cuda_stream)
        msrouse_logL_sym.launches += 1
        _build.check(lib, rc, "kalman_sym launch")
        out = torch.where(in_range_mask(profiles, n), out,
                          torch.full_like(out, math.nan))
    return out[0] if single else out


msrouse_logL_sym.launches = 0
