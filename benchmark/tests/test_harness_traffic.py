"""The traffic generator: the same seed gives the same traffic, another
seed other traffic, the truths are what the traffic file asks for, and a
dataset window's draw in blocks keeps its first block."""
import json

import numpy as np
import torch

import bild_tpu_torch as bt
from benchmark import harness
from benchmark.entries.sample_dataset import Entry
from benchmark.reference import rouse
from benchmark.traffic import generate
from conftest import ROOT, shrink

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


def test_raising_max_calls_keeps_the_first_block():
    """A dataset traffic whose max_calls is raised past block_calls draws
    its first block_calls datasets from the window's own substreams, bit
    for bit as one draw of that size; the later blocks draw other
    datasets of the same sizes."""
    traffic = shrink(json.loads((ROOT / "benchmark" / "traffic" / "lockstep-T100-1024.json")
                                .read_text()))
    block, per, T = traffic["block_calls"], traffic["per_call"], traffic["T"]
    traffic["max_calls"] = 3 * block + 2
    cfg = json.loads((ROOT / "benchmark" / "configs" / "rouse2-readme.json").read_text())
    device = torch.device("cpu")
    kind = harness.model_kind(ROOT, cfg)(bt, cfg, device)
    entry = Entry(harness.Context(bt, cfg, traffic, BIG_SEED, device, kind, warm=False))
    entry.setup()
    truths, sets = entry.truths, entry.sets
    assert truths.shape == (3 * block + 2, per, T) and len(sets) == 3 * block + 2
    assert all(len(s) == per for s in sets)

    once = generate.truths(generate.substream(BIG_SEED, "window", "truths"), block * per, T,
                           2, traffic["max_switches"], "cpu")
    data = kind.trajectories(generate.substream(BIG_SEED, "window", "data"), once)
    assert np.array_equal(truths[:block].reshape(block * per, T), once.numpy())
    first = torch.stack([t.data for s in sets[:block] for t in s])
    assert torch.equal(first, data)
    later = torch.stack([t.data for s in sets[block:2 * block] for t in s])
    assert not torch.equal(later, first)
    assert not np.array_equal(truths[block:2 * block], truths[:block])
