from .base import MultiStateModel  # noqa: F401
from .msrouse import MultiStateRouse  # noqa: F401
