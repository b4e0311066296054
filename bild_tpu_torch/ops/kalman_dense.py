"""
Dense-covariance Rouse-Kalman likelihood: the CUDA kernel
``csrc/kalman_dense.cu`` and its plain PyTorch version.

Counterpart of `bild_tpu.ops.kalman_pallas.msrouse_logL_pallas` (the Pallas
kernel ``kalman_pallas.py::_kernel``): the same likelihood as
`ops.kalman.msrouse_logL_batch`, with a dense ``(q, N, N)`` covariance per
profile and no re-symmetrization. It is the ``'dense'`` selector and the
large-N fallback of the packed kernel (`ops.kalman_sym`).

On the H100 one warp evaluates one profile of one lane (trajectory), with
its covariance in shared memory for the whole frame loop, and a block of
W warps shares the states' operators (see the source). `dense_plan`
chooses W, the shared memory and where the operators live from the
launch's shape: in shared memory when they fit beside the warps, else in
global memory, so that one warp's working set alone bounds N. Shapes
whose one warp exceeds `SMEM_LIMIT` raise.

`msrouse_logL_dense` launches the kernel for CUDA tensors and runs
`msrouse_logL_dense_torch` for CPU tensors; it never falls back from one to
the other. Each keeps a count of its calls: ``msrouse_logL_dense.launches``
and ``msrouse_logL_dense_torch.calls``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from . import _build
from .kalman import as_lanes, in_range_mask, logL_dense_loop

__all__ = ["msrouse_logL_dense", "msrouse_logL_dense_torch",
           "dense_smem_bytes", "dense_plan", "DensePlan", "SMEM_LIMIT",
           "SMEM_PER_SM", "H100_SMS", "MAX_BLOCKS"]

# the most dynamic shared memory one block may use on Hopper (227 KB), and
# the shared memory of one SM (228 KB; each resident block also reserves
# 1 KB of it)
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
# streaming multiprocessors of an H100 SXM; the wrappers ask the device
H100_SMS = 132

# warps per block of the dense kernel, largest first
DENSE_WARPS = (8, 4, 2, 1)

_FLOAT_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _a16(nbytes):
    return -(-nbytes // 16) * 16


def dense_smem_bytes(N, d, q, itemsize, n=2, warps=1, ops_shared=True) -> int:
    """Shared memory of one block of the dense kernel (``dense_layout`` in
    ``csrc/kalman_dense.cu``), N padded to ``NP``, a multiple of 4: with
    ``ops_shared`` the n states' ``B, Sig (NP, NP)`` and ``G (N, d)``;
    ``w``, ``s2`` and ``Cind``; per warp one profile's ``C (q, NP, NP)``,
    a scratch area (``X^T (NP, NP)``, at least the propagated means ``(NP,
    d)`` or ``Cw (q, NP)``, ``1/S (q)`` and ``w.M (d)``), ``M (NP, d)``
    and, with ``ops_shared``, ``Mn (NP, d)``."""
    NP = -(-N // 4) * 4
    NN = NP * NP
    shared = _a16(NP * itemsize) + _a16(q * itemsize) + _a16(4 * d)
    if ops_shared:
        shared += 2 * _a16(n * NN * itemsize) + _a16(n * N * d * itemsize)
    scratch = max(NN, q * NP + q + d, NP * d)
    per_warp = _a16((q * NN + scratch + (2 if ops_shared else 1) * NP * d)
                    * itemsize)
    return shared + warps * per_warp


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """One launch of the dense kernel: ``warps`` profiles per block, the
    operators in shared memory or not."""

    warps: int
    blocks: int
    smem: int
    ops_shared: bool


def dense_plan(L, P, n, N, d, q, itemsize, sms=H100_SMS):
    """Where the operators live and the warps per block for an ``(L, P)``
    launch. The operators go to shared memory if they fit beside one warp,
    else they are read from global memory. Then the most warps (of 8, 4,
    2, 1) that still give every SM two blocks, else one, else one warp per
    block, so that a single-trajectory step (L=1, P=100) spreads over as
    many SMs as it has profiles. Raises if one warp's working set exceeds
    `SMEM_LIMIT`."""
    def smem(w, shared):
        return dense_smem_bytes(N, d, q, itemsize, n, w, shared)

    shared = smem(1, True) <= SMEM_LIMIT
    fits = [w for w in DENSE_WARPS if smem(w, shared) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"dense kernel needs {smem(1, False)} B of shared memory per "
            f"block at n={n}, N={N}, d={d}, q={q}, {itemsize}-byte floats; "
            f"Hopper allows {SMEM_LIMIT}")
    items = L * P

    def blocks(w):
        return -(-items // w)

    chosen = next((w for w in fits if blocks(w) >= 2 * sms),
                  next((w for w in fits if blocks(w) >= sms), fits[-1]))
    return DensePlan(chosen, blocks(chosen), smem(chosen, shared), shared)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def msrouse_logL_dense_torch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                             profiles, ydata, valid):
    """Plain PyTorch version of the dense kernel: the recursion of
    `ops.kalman` without re-symmetrization."""
    msrouse_logL_dense_torch.calls += 1
    return logL_dense_loop(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles,
                           ydata, valid, symmetrize=False)


msrouse_logL_dense_torch.calls = 0


# blocks of one launch: the grid's x dimension holds at most 2^31 - 1
MAX_BLOCKS = 2**31 - 1


def check_cuda_args(floats: dict, profiles, ydata, valid):
    """Shared argument checks of the CUDA wrappers, on the lane form (see
    `ops.kalman.as_lanes`): every float tensor on ``ydata``'s device, in
    one supported dtype, contiguous; int32 ``(L, P, T)`` profiles and a
    bool ``(L, T)`` mask on the same device; at most `MAX_BLOCKS` (lane,
    profile) pairs. Returns the kernel's dtype suffix."""
    dev, dtype = ydata.device, ydata.dtype
    if dtype not in _FLOAT_SUFFIX:
        raise TypeError(f"kernel computes in float32 or float64, not {dtype}")
    for name, x in floats.items():
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}; "
                             f"expected {dtype} on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if profiles.dtype != torch.int32 or profiles.device != dev \
            or not profiles.is_contiguous():
        raise ValueError("profiles must be a contiguous int32 tensor "
                         f"on {dev}")
    if valid.dtype != torch.bool or valid.device != dev \
            or not valid.is_contiguous():
        raise ValueError(f"valid must be a contiguous bool tensor on {dev}")
    L, P, _ = profiles.shape
    if L * P > MAX_BLOCKS:
        raise ValueError(f"{L} lanes x {P} profiles = {L * P} blocks; one "
                         f"launch takes at most {MAX_BLOCKS}")
    return _FLOAT_SUFFIX[dtype]


def cind_tensor(Cind, d, device):
    Cind = torch.as_tensor(Cind, dtype=torch.int32, device=device)
    if Cind.shape != (d,):
        raise ValueError(f"Cind must have shape ({d},); got {tuple(Cind.shape)}")
    return Cind.contiguous()


def msrouse_logL_dense(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                       profiles, ydata, valid):
    """
    Log-likelihoods, arguments and shapes as `ops.kalman.msrouse_logL_batch`
    (``(L, P)`` for L lanes, ``(P,)`` for the single-lane form). CUDA
    tensors launch the kernel, one warp per (lane, profile), the warps
    per block and the operators' place from `dense_plan`, on the current
    stream (no synchronization); CPU tensors run
    `msrouse_logL_dense_torch`. Out-of-range states give NaN.
    """
    if ydata.device.type == "cpu":
        return msrouse_logL_dense_torch(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind,
                                        profiles, ydata, valid)
    if ydata.device.type != "cuda":
        raise ValueError(f"no kernel for device {ydata.device}")
    profiles, ydata, valid, single = as_lanes(profiles, ydata, valid)
    n, N, _ = Bs.shape
    d = Gs.shape[2]
    q = s2.shape[0]
    sfx = check_cuda_args(dict(Bs=Bs, Gs=Gs, Sigs=Sigs, M0s=M0s, C0s=C0s,
                               w=w, s2=s2, ydata=ydata),
                          profiles, ydata, valid)
    if Sigs.shape != (n, N, N) or C0s.shape != (n, N, N) \
            or Gs.shape != (n, N, d) or M0s.shape != (n, N, d) \
            or w.shape != (N,) or ydata.shape[2] != d:
        raise ValueError("inconsistent model shapes")
    L, P, T = profiles.shape
    index = ydata.device.index or 0
    plan = dense_plan(L, P, n, N, d, q, ydata.element_size(),
                      sms=sm_count(index))
    Cind = cind_tensor(Cind, d, ydata.device)
    out = torch.empty((L, P), dtype=ydata.dtype, device=ydata.device)
    if L * P > 0:
        lib, fn = _build.entry("kalman_dense", f"bild_kalman_dense_{sfx}",
                               12, 11)
        rc = fn(Bs.data_ptr(), Gs.data_ptr(), Sigs.data_ptr(),
                M0s.data_ptr(), C0s.data_ptr(), w.data_ptr(), s2.data_ptr(),
                Cind.data_ptr(), profiles.data_ptr(), ydata.data_ptr(),
                valid.data_ptr(), out.data_ptr(), n, N, d, q, L, P, T,
                plan.warps, int(plan.ops_shared), plan.smem, index,
                torch.cuda.current_stream(ydata.device).cuda_stream)
        msrouse_logL_dense.launches += 1
        _build.check(lib, rc, "kalman_dense launch")
        out = torch.where(in_range_mask(profiles, n), out,
                          torch.full_like(out, math.nan))
    return out[0] if single else out


msrouse_logL_dense.launches = 0
