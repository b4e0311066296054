"""
Kernel selection and float32 policy for bild_tpu_torch.

Unlike the JAX package there is no global dtype switch: every constructor
takes an explicit ``device=`` and ``dtype=``. Models run on the GPU unless
the caller asks for the CPU (``device="cpu"``, as the CPU tests do); on a
machine without a GPU a model built without ``device=`` raises
(`resolve_device`). The CPU tests run in float64; the GPU runs float32.

The kernel selector (`set_rouse_kernel`) only matters for CUDA tensors:
``'auto'`` (the default) picks the dense-covariance or the packed kernel
for each launch from its shape, ``'sym'`` and ``'dense'`` force one,
``'torch'`` runs the plain recursion. A model whose tensors lie on the CPU
always takes the plain path (`ops.kalman.msrouse_logL_batch`). The matmul
tier (`set_rouse_matmul`) likewise changes only what the packed kernel
computes on float32 CUDA tensors; under ``'auto'`` a split tier keeps
every launch on the packed kernel.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["KERNELS", "DEFAULT_DEVICE", "resolve_device", "rouse_kernel",
           "set_rouse_kernel", "rouse_matmul", "set_rouse_matmul",
           "resolve_matmul", "SPLIT_MAX_T", "MATMUL_MODES", "exact_fp32",
           "full_fp32"]

# where models live unless the caller says otherwise
DEFAULT_DEVICE = "cuda"

# Which Rouse-Kalman likelihood a CUDA model dispatches to:
#   "auto"  — the default: per launch, the kernel that
#             `ops.kalman_sym.auto_kernel` picks from the launch's shape:
#             the dense kernel where the launch fills the SMs (the dataset
#             runners), the packed kernel's cluster plan where it cannot
#             (sample()'s step, L=1, P=100)
#   "sym"   — packed-symmetric CUDA kernel (`ops.kalman_sym`; bild_tpu's
#             default), for every launch
#   "dense" — dense-covariance CUDA kernel (`ops.kalman_dense`), for every
#             launch
#   "torch" — the plain PyTorch recursion (`ops.kalman`)
KERNELS = ("auto", "sym", "dense", "torch")
_ROUSE_KERNEL = "auto"


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
    """Select the CUDA Rouse-Kalman likelihood: 'auto' (the default: chosen
    per launch from its shape), 'sym', 'dense' or 'torch'. Models pick it
    up at their next likelihood call."""
    global _ROUSE_KERNEL
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; use one of {KERNELS}")
    _ROUSE_KERNEL = name


# Matmul tier of the packed kernel (`ops.kalman_sym`; float32 only, the
# dense kernel and the plain recursion are always exact), as bild_tpu's
# `config.rouse_matmul`:
#   'auto' - 'split' on lockstep dispatches (`sample_batch`,
#       `sample_dataset`, the adaptive runner, the boundary climb, the
#       sharded runner) of trajectories of at most `SPLIT_MAX_T` frames,
#       'exact' everywhere else (`sample()`, direct `logL_batch` calls);
#   'exact' (the default here) - every product in float32;
#   'split' - the covariance conjugation, the update contraction and the
#       mean propagation as three bfloat16 products with float32 sums,
#       ``A.B ~ Ahi.Bhi + Ahi.Blo + Alo.Bhi`` (``hi = bf16(x)``, ``lo =
#       bf16(x - hi)``): the conjugation runs on the tensor cores;
#   'split_cov' - the conjugation split, the other two products exact.
# The split error compounds over the recursion (bild_tpu's parity ladder on
# a TPU v5e: 0.085 centered nats at T=100, 0.52 at T=300, 4.5 at T=1000),
# so 'auto' splits only trajectories of at most SPLIT_MAX_T frames.
# Explicit modes are never overridden. bild_tpu ships 'auto'; this package
# ships 'exact', because on the H100 'split' misses the parity ladder's
# T=100 bar of 1e-4 relative (bild_tpu's own split misses it on the same
# data) and runs slower than 'exact' (PERF.md, section 6; chip_smoke.py's
# split phase checks that gate).
MATMUL_MODES = ("auto", "exact", "split", "split_cov")
SPLIT_MAX_T = 128
_ROUSE_MATMUL = "exact"


def rouse_matmul() -> str:
    return _ROUSE_MATMUL


def set_rouse_matmul(mode: str) -> None:
    """Select the packed kernel's matmul tier: 'auto', 'exact', 'split' or
    'split_cov'. Models pick it up at their next likelihood call."""
    global _ROUSE_MATMUL
    if mode not in MATMUL_MODES:
        raise ValueError(f"rouse_matmul must be one of {MATMUL_MODES}, "
                         f"got {mode!r}")
    _ROUSE_MATMUL = mode


def resolve_matmul(context: str = "single", T: int | None = None) -> str:
    """The tier for a dispatch context: ``'lockstep'`` (dataset and batch
    runners) or ``'single'`` (`sample()`, direct calls, validation). Only
    'auto' depends on it: 'split' for lockstep dispatches of trajectories
    of at most `SPLIT_MAX_T` frames (or of unknown length), else
    'exact'."""
    if context not in ("lockstep", "single"):
        raise ValueError(f"unknown matmul context {context!r}")
    if _ROUSE_MATMUL == "auto":
        if context == "lockstep" and (T is None or T <= SPLIT_MAX_T):
            return "split"
        return "exact"
    return _ROUSE_MATMUL


def exact_fp32() -> None:
    """Turn TF32 off for matrix products and convolutions, so that the
    plain PyTorch versions compute in full float32 like the kernels do.
    Call it before timing or comparing the plain versions on a GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def full_fp32():
    """Matrix products in full float32 inside the block, whatever the
    global TF32 setting (`bild_tpu`'s ``default_matmul_precision("highest")``
    around its square-root and temporal-parallel filters); the setting is
    restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
