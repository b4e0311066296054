from .choice import ChoiceSampler  # noqa: F401
from .core import sample, SamplingResults  # noqa: F401
