"""The boundary climb's share of the dataset cells' traced calls: time in
the program's ``dataset.climb`` spans (`postproc.optimize_boundary_batch`
and its batch) over time in its ``sample_dataset`` spans, in percent."""
from benchmark.metrics import _program


def read(rec):
    return _program.span_share("dataset.climb", "sample_dataset")
