from .cfc import CFC  # noqa: F401
from .sampler import AmisState, FixedkSampler  # noqa: F401
