"""
Build and load the CUDA kernels under ``bild_tpu_torch/csrc/``.

Each ``csrc/<name>.cu`` is compiled on first CUDA use by ``nvcc`` into a
shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

and loaded with `ctypes`. The file name carries a hash of the source, of
the shared headers in ``csrc/`` and of the flags, so an edited source
builds anew and an unchanged one is reused. ``load(name, defines)`` builds
a copy with preprocessor macros defined (``-D``), as a library of its own. No source includes PyTorch's headers: a build
takes seconds, not minutes.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `check` raises on a non-zero code. Nothing here
runs at import time, so importing the package never looks for ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "load", "entry", "check"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``$CUDA_PATH``, ``PATH`` or the default
    toolkit location, in that order."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash(name: str, defines=()) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        if path.suffix == ".cuh" or path.stem == name:
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(name: str, defines=()) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    tag = "".join(f"-{d.lower()}" for d in defines)
    out = BUILD_DIR / f"{name}{tag}-{_source_hash(name, defines)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC),
           "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed, with the
    macros ``defines`` defined."""
    lib = ctypes.CDLL(str(_build(name, defines)))
    lib.bild_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bild_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def entry(name: str, symbol: str, n_ptr: int, n_int: int, n_double: int = 0):
    """``(lib, fn)`` for the C entry point ``symbol(ptr * n_ptr, int * n_int,
    double * n_double, stream) -> int`` of ``csrc/<name>.cu``; pointers and
    the stream are ``c_void_p`` so 64-bit addresses are not cut."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_double] * n_double + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.bild_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
