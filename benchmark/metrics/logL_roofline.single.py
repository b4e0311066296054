"""The Rouse likelihood's share of its roofline at ``sample()``'s launches:
the least time of every profile that the traced calls scored (`work`),
over the device time of every launch of a kernel named in
``kernels/rouse_logL.json``, in percent."""
from benchmark.metrics import _common


def read(rec):
    return _common.roofline(rec)
