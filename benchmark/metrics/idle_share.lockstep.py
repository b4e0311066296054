"""The device's idle share of the traced part of a dataset cell's window:
1 - the union of the device events' intervals over the traced wall, in
percent."""
from benchmark.metrics import _common


def read(rec):
    return _common.idle(rec)
