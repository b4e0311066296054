"""Host calls that put work on the device (kernel and graph launches,
copies, fills: the raw CUDA-activity trace's ``LAUNCH_CALLS``) over the
whole traced ``sample_dataset`` calls (stacking, informed init, the step
graphs' replays and their copies, the climb, the marginals, the fetch),
per AMIS step (``parallel.batch.run_steps.steps``)."""
from benchmark.metrics import _common


def read(rec):
    return _common.host_calls_per_step(rec)
