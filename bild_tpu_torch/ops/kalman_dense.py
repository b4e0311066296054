"""
Dense-covariance Rouse-Kalman likelihood: the CUDA kernel
``csrc/kalman_dense.cu`` and its plain PyTorch version.

Counterpart of `bild_tpu.ops.kalman_pallas.msrouse_logL_pallas` (the Pallas
kernel ``kalman_pallas.py::_kernel``): the same likelihood as
`ops.kalman.msrouse_logL_batch`, with a dense ``(q, N, N)`` covariance per
profile and no re-symmetrization. It is the ``'dense'`` selector and the
large-N fallback of the packed kernel (`ops.kalman_sym`).

On the H100 one block evaluates one profile of one lane (trajectory), with
its covariance in shared memory for the whole frame loop; what bounds it
is the latency of the per-frame ``__syncthreads()`` chain (see the
source). Any L and P run, with no padding.

`msrouse_logL_dense` launches the kernel for CUDA tensors and runs
`msrouse_logL_dense_torch` for CPU tensors; it never falls back from one to
the other. Each keeps a count of its calls: ``msrouse_logL_dense.launches``
and ``msrouse_logL_dense_torch.calls``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .kalman import as_lanes, in_range_mask, logL_dense_loop

__all__ = ["msrouse_logL_dense", "msrouse_logL_dense_torch",
           "dense_smem_bytes", "SMEM_LIMIT", "MAX_BLOCKS"]

# the most dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448

_FLOAT_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def dense_smem_bytes(N, d, q, itemsize) -> int:
    """Shared memory of one block of the dense kernel."""
    return ((q + 1) * N * N + 2 * N * d + q * N + q + d + N) * itemsize


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
    tensors launch the kernel, one block per (lane, profile), on the
    current stream (no synchronization); CPU tensors run
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
    smem = dense_smem_bytes(N, d, q, ydata.element_size())
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"dense kernel needs {smem} B of shared memory per block at "
            f"N={N}, d={d}, q={q}, {ydata.dtype}; Hopper allows {SMEM_LIMIT}")
    Cind = cind_tensor(Cind, d, ydata.device)
    L, P, T = profiles.shape
    out = torch.empty((L, P), dtype=ydata.dtype, device=ydata.device)
    if L * P > 0:
        lib, fn = _build.entry("kalman_dense", f"bild_kalman_dense_{sfx}",
                               12, 8)
        rc = fn(Bs.data_ptr(), Gs.data_ptr(), Sigs.data_ptr(),
                M0s.data_ptr(), C0s.data_ptr(), w.data_ptr(), s2.data_ptr(),
                Cind.data_ptr(), profiles.data_ptr(), ydata.data_ptr(),
                valid.data_ptr(), out.data_ptr(), n, N, d, q, L, P, T,
                ydata.device.index or 0,
                torch.cuda.current_stream(ydata.device).cuda_stream)
        msrouse_logL_dense.launches += 1
        _build.check(lib, rc, "kalman_dense launch")
        out = torch.where(in_range_mask(profiles, n), out,
                          torch.full_like(out, math.nan))
    return out[0] if single else out


msrouse_logL_dense.launches = 0
