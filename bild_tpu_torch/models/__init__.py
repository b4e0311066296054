from .base import MultiStateModel  # noqa: F401
from .msrouse import MultiStateRouse  # noqa: F401
from .factorized import FactorizedModel  # noqa: F401
