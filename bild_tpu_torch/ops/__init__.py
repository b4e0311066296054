from .kalman import msrouse_logL_batch  # noqa: F401
from .kalman_dense import msrouse_logL_dense, msrouse_logL_dense_torch  # noqa: F401
from .kalman_sym import (SymOperators, msrouse_logL_sym,  # noqa: F401
                         msrouse_logL_sym_torch)
