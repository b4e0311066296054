"""
The import guard: a run that has loaded JAX or the JAX package prints no
result. Names are compared by their top-level part whole (before the first
dot), so ``bild_tpu_torch`` is not ``bild_tpu``.
"""
from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

FORBIDDEN = ("jax", "jaxlib", "flax", "bild_tpu")


def forbidden_loaded(modules=None):
    """The sorted top-level names in ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
