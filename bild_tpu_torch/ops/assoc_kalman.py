"""
The temporal-parallel (associative-scan) Kalman likelihood lives in
`bild_tpu_torch.experimental.assoc_kalman`, as in `bild_tpu`; this module
keeps `bild_tpu`'s ``ops.assoc_kalman`` import path.
"""
from ..experimental.assoc_kalman import msrouse_logL_assoc  # noqa: F401

__all__ = ["msrouse_logL_assoc"]
