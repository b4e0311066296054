"""Host milliseconds per ``sample()`` call in its choice decisions: time in
the program's ``sample.decide`` spans (`ChoiceSampler`, `KLD_moreSamples`,
`KLD_omitK`) over its ``sample`` spans, in the traced calls."""
from benchmark.metrics import _program


def read(rec):
    return _program.ms_per_span("sample.decide", "sample")
