from .kalman import msrouse_logL_batch, msrouse_logL_single  # noqa: F401
from .kalman_dense import msrouse_logL_dense, msrouse_logL_dense_torch  # noqa: F401
from .kalman_sym import (SymOperators, msrouse_logL_sym,  # noqa: F401
                         msrouse_logL_sym_torch)
from .kalman_sqrt import msrouse_logL_sqrt  # noqa: F401
from .assoc_kalman import msrouse_logL_assoc  # noqa: F401
