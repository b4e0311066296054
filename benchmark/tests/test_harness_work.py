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
