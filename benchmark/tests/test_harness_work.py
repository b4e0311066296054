"""The yardstick: the least work of the likelihood, the roofline share
read the same whichever kernel did the work, busy time as a union of
intervals, and the tail's sample count."""
import numpy as np

from benchmark import trace, work
from benchmark.metrics import _common


def test_kernel_work_reads_as_recorded():
    """232.0 GFLOP and 3.463 ms at L=640, P=128, T=100 as recorded in
    PERF.md's kernel table, at that launch's observed frames: its mask left about 5 % of the 64,000
    (lane, frame) pairs out. With every frame observed: 232.7 and 3.473."""
    flops, nbytes = work.kernel_work(640, 128, 100, 2, 20, 3, 1, 60740)
    ms, by = work.bound_ms(flops, nbytes)
    assert round(flops / 1e9, 1) == 232.0
    assert round(ms, 3) == 3.463 and by == "operations"
    flops, nbytes = work.kernel_work(640, 128, 100, 2, 20, 3, 1, 640 * 100)
    assert round(flops / 1e9, 1) == 232.7
    assert round(work.bound_ms(flops, nbytes)[0], 3) == 3.473


def test_least_seconds_counts_each_profile_at_its_own_length():
    a, _ = work.least_seconds([[100, 100, 100]], 2, 20, 3, 1)
    b, _ = work.least_seconds([[100, 1000, 1000]], 2, 20, 3, 1)
    c, _ = work.least_seconds([[50, 100, 100], [50, 100, 100]], 2, 20, 3, 1)
    assert 9.5 < b / a < 10.5
    assert abs(c / a - 1) < 1e-3


def record(kernels, profiles=((1000, 100, 100),)):
    return {"kernels": kernels, "profiles": [list(p) for p in profiles],
            "sizes": {"n": 2, "N": 20, "d": 3, "q": 1}, "window_s": 1.0, "busy_s": 0.5}


def test_roofline_reads_the_same_work_for_every_kernel():
    least, _ = work.least_seconds([[1000, 100, 100]], 2, 20, 3, 1)
    names = ["void kalman_sym_kernel<float, double>(...)", "kalman_sym_cluster_kernel",
             "void kalman_sym_split_kernel<1>(...)", "kalman_dense_kernel<float>"]
    shares = [_common.roofline(record({n: [10, 4 * least]})) for n in names]
    assert np.allclose(shares, 25.0)
    # the device time at the least time reads 100 %, and other kernels do not count
    full = _common.roofline(record({names[0]: [1, least], "gamma_accept_kernel": [9, 1.0]}))
    assert abs(full - 100.0) < 1e-9
    # nothing to read: no likelihood launch, or no profile scored
    assert _common.roofline(record({"gamma_accept_kernel": [9, 1.0]})) is None
    assert _common.roofline(record({names[0]: [1, least]}, profiles=())) is None


def test_union_of_overlapping_intervals():
    ns = 1_000_000_000
    assert trace.union_seconds([(0, ns), (ns // 2, 2 * ns), (3 * ns, 4 * ns)]) == 3.0
    assert trace.union_seconds([(0, 4 * ns), (ns, 2 * ns)]) == 4.0
    assert trace.union_seconds([]) == 0.0
    gaps = trace.idle_gaps([(0, 10), (5, 20), (40, 50), (55, 60)],
                           [(18, 45, "cudaStreamSynchronize"), (51, 52, "cudaLaunchKernel")])
    assert gaps == [["host in cudaStreamSynchronize", 20e-9],
                    ["host after cudaLaunchKernel", 5e-9]]


def test_the_tail_has_ten_samples_beyond_it():
    """At 200 calls, the fewest that the sample cell's window must hold,
    ten lie beyond the 95th percentile."""
    walls = np.random.default_rng(3).lognormal(size=200)
    assert np.sum(walls > np.percentile(walls, 95)) >= 10


class _Event:
    def __init__(self, device, name, start, duration):
        self._device, self._name, self._start, self._duration = device, name, start, duration

    def device_type(self):
        return self._device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration


def test_a_window_reads_its_events():
    """Device time by kernel, busy time, launch calls and idle gaps, from
    the profiler's events."""
    from types import SimpleNamespace

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_Event(cpu, "cudaLaunchKernel", 0, 5), _Event(cuda, "k1", 10, 40),
              _Event(cuda, "k2", 30, 30), _Event(cpu, "cudaGraphLaunch", 60, 5),
              _Event(cpu, "cudaStreamSynchronize", 70, 100), _Event(cuda, "k1", 200, 50)]
    win = trace.DeviceWindow()
    win._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    win._t0, win._t1 = 1.0, 3.5
    rec = win.read()
    assert rec["kernels"] == {"k1": [2, 90e-9], "k2": [1, 30e-9]}
    assert rec["device_ops"] == [["k1", 90e-9], ["k2", 30e-9]]
    assert rec["busy_s"] == 100e-9 and rec["window_s"] == 2.5 and rec["launch_calls"] == 2
    assert rec["idle_gaps"] == [["host in cudaStreamSynchronize", 140e-9]]
