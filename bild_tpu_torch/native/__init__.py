"""
The native (C++) CSV loader, loaded with ctypes (counterpart of
`bild_tpu.native`).

``loader.cpp`` is compiled on first use by ``g++`` into
``bild_tpu_torch/_build/`` (the file name carries a hash of the source and
the flags, so an edited source builds anew) and loaded with `ctypes`. If
the build fails, `get_lib` returns None and `io` falls back to its
pure-Python parser, which has the same semantics.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path

__all__ = ["get_lib"]

_SRC = Path(__file__).resolve().parent / "loader.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None


def _build() -> Path | None:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out = _BUILD_DIR / f"loader-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        tmp.unlink(missing_ok=True)
        warnings.warn(f"building the native CSV loader failed ({exc}); "
                      "falling back to the Python parser")
        return None
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
    return out


def get_lib():
    """The loaded native library, built on first use; None if it cannot be
    built (callers fall back to Python)."""
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.bild_csv_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.bild_csv_load.restype = ctypes.c_int
    lib.bild_csv_dims.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int)]
    lib.bild_csv_dims.restype = None
    lib.bild_csv_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.bild_csv_fill.restype = None
    lib.bild_csv_free.argtypes = [ctypes.c_void_p]
    lib.bild_csv_free.restype = None
    _lib = lib
    return _lib
