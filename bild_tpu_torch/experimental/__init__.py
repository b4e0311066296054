"""
Experimental components (counterpart of `bild_tpu.experimental`):
implemented and tested, but on no default dispatch path; import
explicitly.

- `assoc_kalman`: the temporal-parallel (associative-scan) Kalman
  likelihood, with frames split over a ``time`` mesh
  (`MultiStateRouse.logL_batch_assoc`).
"""
from .assoc_kalman import msrouse_logL_assoc  # noqa: F401
