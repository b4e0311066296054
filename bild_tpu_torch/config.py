"""
Kernel selection and float32 policy for bild_tpu_torch.

Unlike the JAX package there is no global dtype switch: every constructor
takes an explicit ``device=`` and ``dtype=``. The CPU tests run in float64;
the GPU runs float32.

The selector only matters for CUDA tensors. A model whose tensors lie on
the CPU always takes the plain path (`ops.kalman.msrouse_logL_batch`).
"""
from __future__ import annotations

import torch

__all__ = ["KERNELS", "rouse_kernel", "set_rouse_kernel", "exact_fp32"]

# Which Rouse-Kalman likelihood a CUDA model dispatches to:
#   "sym"   — packed-symmetric CUDA kernel (`ops.kalman_sym`, the default,
#             mirroring bild_tpu's default)
#   "dense" — dense-covariance CUDA kernel (`ops.kalman_dense`)
#   "torch" — the plain PyTorch recursion (`ops.kalman`)
KERNELS = ("sym", "dense", "torch")
_ROUSE_KERNEL = "sym"


def rouse_kernel() -> str:
    return _ROUSE_KERNEL


def set_rouse_kernel(name: str) -> None:
    """Select the CUDA Rouse-Kalman likelihood: 'sym', 'dense' or 'torch'.
    Models pick it up at their next likelihood call."""
    global _ROUSE_KERNEL
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; use one of {KERNELS}")
    _ROUSE_KERNEL = name


def exact_fp32() -> None:
    """Turn TF32 off for matrix products and convolutions, so that the
    plain PyTorch versions compute in full float32 like the kernels do.
    Call it before timing or comparing the plain versions on a GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
