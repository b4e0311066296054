"""The traffic generator: the same seed gives the same traffic, another
seed other traffic, and the truths are what the traffic file asks for."""
import numpy as np
import torch

from benchmark.reference import rouse
from benchmark.traffic import generate

LOOPS = {2: (None, (0, -1)), 3: (None, (0, -1), (0, 10))}
ARRAYS = rouse.operators(20, 1.0, 5.0, 3, 1.0, LOOPS[2])
BIG_SEED = 2**31 + 987654321


def make(seed, B=64, T=50, n=2):
    truths = generate.truths(generate.substream(seed, "t"), B, T, n, 4, "cpu")
    arrays = rouse.operators(20, 1.0, 5.0, 3, 1.0, LOOPS[n])
    data = generate.trajectories(generate.substream(seed, "d"), truths, arrays, 0.1, "cpu")
    return truths.numpy(), data.numpy()


def test_same_seed_same_traffic():
    t1, d1 = make(BIG_SEED)
    t2, d2 = make(BIG_SEED)
    assert np.array_equal(t1, t2) and np.array_equal(d1, d2)


def test_other_seed_other_traffic():
    t1, d1 = make(BIG_SEED)
    t2, d2 = make(BIG_SEED + 1)
    assert not np.array_equal(t1, t2) and not np.array_equal(d1, d2)


def test_substreams_differ_by_tag_and_seed():
    seeds = {generate.substream(s, tag) for s in (1, 2**33 + 1) for tag in ("a", "b")}
    seeds |= {generate.substream(1, "program", i) for i in range(3)}
    assert len(seeds) == 7 and all(0 <= s < 2**63 for s in seeds)


def test_truths_follow_the_traffic_file():
    for n in (2, 3):
        truths, data = make(7, B=400, T=100, n=n)
        switches = generate.switch_counts(truths)
        assert switches.min() == 0 and switches.max() == 4
        assert set(np.unique(truths)) == set(range(n))
        assert np.all(np.bincount(switches, minlength=5) > 40)   # uniform in 0..4
        assert data.shape == (400, 100, 3) and data.dtype == np.float32
        assert np.all(np.isfinite(data))


def test_trajectories_follow_the_model_variance():
    """The end-to-end distance's variance per dimension in the steady state
    of each state: w C_ss w + the localization error squared."""
    B = 4000
    for s in (0, 1):
        profiles = torch.full((B, 1), s)
        data = generate.trajectories(5, profiles, ARRAYS, 0.1, "cpu").double()
        want = ARRAYS["w"] @ ARRAYS["C0s"][s] @ ARRAYS["w"] + 0.01
        got = float(data.var())
        assert abs(got / want - 1) < 0.05
