"""
Kernel selection and float32 policy for bild_tpu_torch.

Unlike the JAX package there is no global dtype switch: every constructor
takes an explicit ``device=`` and ``dtype=``. Models run on the GPU unless
the caller asks for the CPU (``device="cpu"``, as the CPU tests do); on a
machine without a GPU a model built without ``device=`` raises
(`resolve_device`). The CPU tests run in float64; the GPU runs float32.

The selector only matters for CUDA tensors. A model whose tensors lie on
the CPU always takes the plain path (`ops.kalman.msrouse_logL_batch`).
"""
from __future__ import annotations

import torch

__all__ = ["KERNELS", "DEFAULT_DEVICE", "resolve_device", "rouse_kernel",
           "set_rouse_kernel", "exact_fp32"]

# where models live unless the caller says otherwise
DEFAULT_DEVICE = "cuda"

# Which Rouse-Kalman likelihood a CUDA model dispatches to:
#   "sym"   — packed-symmetric CUDA kernel (`ops.kalman_sym`, the default,
#             mirroring bild_tpu's default)
#   "dense" — dense-covariance CUDA kernel (`ops.kalman_dense`)
#   "torch" — the plain PyTorch recursion (`ops.kalman`)
KERNELS = ("sym", "dense", "torch")
_ROUSE_KERNEL = "sym"


def resolve_device(device) -> torch.device:
    """``device`` as a `torch.device`; raises if it is a CUDA device and no
    GPU is available, so that nothing quietly runs elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA device is available; "
            "models run on the GPU unless built with device='cpu'")
    return device


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
