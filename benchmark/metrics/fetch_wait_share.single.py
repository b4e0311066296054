"""The share of ``sample()``'s wall that its host spends blocked in the
AMIS steps' fetches (each ``FixedkSampler.steps`` call's packed copy to the
host, which waits for the step's device work): time in the program's
``sampler.fetch`` spans over its ``sample`` spans, in percent."""
from benchmark.metrics import _program


def read(rec):
    return _program.span_share("sampler.fetch", "sample")
