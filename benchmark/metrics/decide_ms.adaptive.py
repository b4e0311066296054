"""Host milliseconds per adaptive round in its decisions and slot packing:
time in the program's ``adaptive.decide`` spans over its
``adaptive.round`` spans, in the traced calls. A call's spans are its
rounds and the closing decision pass that finds every trajectory settled."""
from benchmark.metrics import _program


def read(rec):
    return _program.ms_per_span("adaptive.decide", "adaptive.round")
