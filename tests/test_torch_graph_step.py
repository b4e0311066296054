"""The dataset runners' step as a capturable program (bild_tpu_torch.
parallel.graphs): the gamma sampler's capped rounds against its loop,
the gamma kernel's stream derivation (its hoisted table of round words)
against `LaneRNG` and its grid planner `gamma_plan`,
the fold by a device step tensor against the host int, the in-place step
of `run_lanes` / `run_slots` against copies of their previous eager loops
(kept below) through `sample_batch` and the adaptive runner, and the graph
path's buffers and cache driven on the CPU with a stand-in capture. On the
card, graphed against eager bit for bit (marked `cuda`)."""
import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.amis import cfc as tcfc
from bild_tpu_torch.amis import dirichlet as tdir
from bild_tpu_torch.amis.sampler import amis_propose, amis_update
from bild_tpu_torch.infer import adaptive
from bild_tpu_torch.lanes import LaneRNG, normal, uniform
from bild_tpu_torch.ops import counters
from bild_tpu_torch.parallel import batch as tbatch
from bild_tpu_torch.parallel import graphs
from bild_tpu_torch.parallel import sample_batch

torch.set_num_threads(1)

F64 = torch.float64
KW = dict(k_max=3, steps_per_k=6, N=24, informed_init=True, marginals=True)
AKW = dict(k_max=3, N=24, max_steps_per_k=8, init_steps=2, steps_per_round=1,
           certainty_in_k=0.9999, samplesize=256, informed_init=True,
           marginals=True)


# -- copies of the previous eager code, the reference of the in-place step --

def loop_standard_gamma(alpha, generator=None):
    """`standard_gamma` as it was: asks the device after every round.
    Returns the draws and the rounds run."""
    boost = alpha < 1
    a = torch.where(boost, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    rnd = 0
    while True:
        x = normal(generator, a.shape, 2 * rnd, a.dtype, a.device)
        u = uniform(generator, a.shape, 2 * rnd + 1, a.dtype, a.device)
        v = (1.0 + c * x) ** 3
        pos = v > 0
        logv = torch.log(torch.where(pos, v, 1.0))
        ok = pos & (torch.log(u) < 0.5 * x * x + d - d * v + d * logv)
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
        rnd += 1
        if not bool(todo.any()):
            break
    u = uniform(generator, a.shape, -1, a.dtype, a.device)
    loop_standard_gamma.rounds = rnd
    return torch.where(boost, out * u ** (1.0 / alpha), out)


def loop_run_lanes(logL_fn, lane_data, state, rng, transitions, active,
                   logprior, cb, pb, *, N, T, start, stop, informed=None,
                   mom_maxiter=1000):
    """`run_lanes` as it was: a host step index shared by the lanes."""
    for i in range(start, stop):
        ss, th, profiles = amis_propose(state, rng.fold(i), transitions,
                                        N=N, T=T, active=active, exact=True)
        logLs = logL_fn(profiles, lane_data).to(state.logLs.dtype)
        state, _ = amis_update(state, ss, th, logLs, transitions, logprior,
                               cb, pb, maxiter=mom_maxiter, active=active,
                               exact=True)
        if i == 0 and informed is not None:
            a_inf, logp_inf, use = informed
            state.a_params[:, 1] = torch.where(use[:, None], a_inf,
                                               state.a_params[:, 1])
            state.logps[:, 1] = torch.where(use[:, None, None], logp_inf,
                                            state.logps[:, 1])
    return state


def loop_run_slots(logL_fn, lane_data, state, rng, transitions, active,
                   logprior, cb, pb, *, N, T, steps, live, informed=None,
                   mom_maxiter=1000):
    """`run_slots` as it was: a clone of the state on every step."""
    S = state.logLs.shape[1]
    for _ in range(steps):
        ok = live & (state.n_steps < S)
        ss, th, profiles = amis_propose(state, rng.fold(state.n_steps),
                                        transitions, N=N, T=T, active=active,
                                        exact=True)
        logLs = logL_fn(profiles, lane_data).to(state.logLs.dtype)
        new, _ = amis_update(state._map(torch.clone), ss, th, logLs,
                             transitions, logprior, cb, pb,
                             maxiter=mom_maxiter, active=active, exact=True)
        if informed is not None:
            a_inf, logp_inf, use = informed
            seed = use & (new.n_steps == 1)
            new.a_params[:, 1] = torch.where(seed[:, None], a_inf,
                                             new.a_params[:, 1])
            new.logps[:, 1] = torch.where(seed[:, None, None], logp_inf,
                                          new.logps[:, 1])
        state = adaptive._keep(ok, new, state)
    return state


def truths(B=5, T=36):
    """Looping profiles: none, one loop, a late loop, two loops, all looped
    (the first ``B``), on a frame grid of ``T``."""
    prof = np.zeros((5, T), dtype=int)
    prof[1, T // 4:(3 * T) // 4] = 1
    prof[2, T // 2:] = 1
    prof[3, T // 8:(3 * T) // 8] = 1
    prof[3, (2 * T) // 3:] = 1
    prof[4, :] = 1
    return prof[:B]


@pytest.fixture(scope="module")
def rouse():
    model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3, localization_error=0.1,
                                      device="cpu", dtype=F64)
    batch = model.trajectories_from_loopingprofiles(
        truths(), generator=torch.Generator().manual_seed(3))
    return model, batch


def gen(seed):
    return torch.Generator().manual_seed(seed)


def previous(monkeypatch):
    """Route the runners through the copies of their previous loops."""
    monkeypatch.setattr(tdir, "standard_gamma", loop_standard_gamma)
    monkeypatch.setattr(tbatch, "run_lanes", loop_run_lanes)
    monkeypatch.setattr(adaptive, "run_lanes", loop_run_lanes)
    monkeypatch.setattr(adaptive, "run_slots", loop_run_slots)


def stand_in_graphs(monkeypatch):
    """The graph path on the CPU: a 'capture' that records the step and a
    replay that calls it on the graph's buffers."""
    graphs.clear()
    monkeypatch.setattr(graphs, "graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", lambda fn: fn)


def assert_same(a, b, fields=("evidence", "evidence_se", "map_profiles",
                              "marginals", "mom_ok")):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), f


# -- the gamma sampler ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5, "mixed"])
def test_lane_gamma_equals_the_loop(dtype, alpha):
    """The capped plain loop of `gamma_accept` (the CPU's, and the kernel's
    plain version) gives the previous loop's bits on lane streams, in cases
    that need three or four rounds (6,000 entries per lane)."""
    L, M = 3, 6000
    if alpha == "mixed":
        a = torch.linspace(0.05, 6.0, M, dtype=dtype).expand(L, M)
    else:
        a = torch.full((L, M), alpha, dtype=dtype)
    rng = LaneRNG.from_seeds([11, 12, 13], "cpu").fold(5)
    want = loop_standard_gamma(a, rng)
    assert loop_standard_gamma.rounds >= 3
    flag = torch.zeros((), dtype=torch.bool)
    got = tdir.standard_gamma(a, LaneRNG(rng.keys, flag))
    assert torch.equal(got, want) and not bool(flag)
    assert torch.equal(tdir.standard_gamma(a, rng), want)
    assert (got >= 0).all() and got.dtype == dtype


def test_float32_gamma_needs_many_rounds_at_large_shapes():
    """Why the gamma rounds are not a fixed small count: in float32 the
    test cancels at a degenerate proposal's concentrations (the update's
    1e10 cap), about half the draws are rejected per round, and 20,000
    entries need more than 12 rounds (float64 needs one or two)."""
    rounds = {}
    for dtype in (torch.float32, F64):
        a = torch.full((1, 20000), 1e9, dtype=dtype)
        d = a - 1.0 / 3.0
        c = 1.0 / torch.sqrt(9.0 * d)
        x = normal(LaneRNG.from_seeds([5], "cpu"), a.shape, 0, dtype, "cpu")
        u = uniform(LaneRNG.from_seeds([5], "cpu"), a.shape, 1, dtype, "cpu")
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v))
        loop_standard_gamma(a, LaneRNG.from_seeds([5], "cpu"))
        rounds[dtype] = (float(ok.to(F64).mean()), loop_standard_gamma.rounds)
    assert rounds[torch.float32][0] < 0.7 and rounds[torch.float32][1] > 12
    assert rounds[F64][0] > 0.95 and rounds[F64][1] <= 2


def test_gamma_flag_when_the_rounds_run_out(monkeypatch):
    """With the cap cut to one round, an entry rejected in it sets the
    streams' flag; with no flag the sampler raises and counts the event."""
    a = torch.full((2, 500), 1.5, dtype=F64)
    rng = LaneRNG.from_seeds([1, 2], "cpu")
    monkeypatch.setattr(tdir, "GAMMA_MAX_ROUNDS", 1)
    flag = torch.zeros((), dtype=torch.bool)
    tdir.standard_gamma(a, LaneRNG(rng.keys, flag))
    assert bool(flag)
    before = tdir.standard_gamma.exhausted
    with pytest.raises(RuntimeError, match="not accepted in 1 rejection"):
        tdir.standard_gamma(a, rng)
    assert tdir.standard_gamma.exhausted == before + 1
    with pytest.raises(RuntimeError):
        tdir.check_exhausted(flag)
    tdir.check_exhausted(torch.zeros((), dtype=torch.bool))


def test_gamma_accept_needs_the_flag():
    """`gamma_accept` takes only streams that carry an exhaustion flag (the
    runners' do); `standard_gamma` gives flagless streams one and reads it
    at once, with the same draws."""
    a = torch.full((2, 300), 2.5, dtype=F64)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    rng = LaneRNG.from_seeds([4, 8], "cpu")
    with pytest.raises(ValueError, match="exhaustion flag"):
        tdir.gamma_accept(d, c, rng)
    flag = torch.zeros((), dtype=torch.bool)
    assert torch.equal(tdir.standard_gamma(a, rng),
                       tdir.standard_gamma(a, LaneRNG(rng.keys, flag)))
    assert not bool(flag)


def test_generator_gamma_keeps_its_loop():
    """A `torch.Generator` source still loops until every entry is taken."""
    a = torch.full((4000,), 0.7, dtype=F64)
    got = tdir.standard_gamma(a, gen(3))
    want = loop_standard_gamma(a, gen(3))
    assert torch.equal(got, want)


M64 = 2**64 - 1


def mix(x):
    """SplitMix64's finalizer on a Python int, as csrc/gamma_accept.cu
    computes it on an unsigned 64-bit word."""
    x &= M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def fold(k, t):
    """`LaneRNG.fold` of one key, as csrc/gamma_accept.cu computes it."""
    return mix(k ^ mix(t + 0x632BE59BD9B4E019))


def round_words(key, rnd):
    """The three stream words of round ``rnd`` of the lane keyed ``key``:
    the normal's two and the test's."""
    knorm = fold(key & M64, 2 * rnd)
    return fold(knorm, 0), fold(knorm, 1), fold(key & M64, 2 * rnd + 1)


def round_table(key):
    """The table a block of the gamma kernel computes once for its lane:
    the stream words of rounds 0 .. `GAMMA_HOISTED_ROUNDS` - 1."""
    return [round_words(key, rnd) for rnd in range(tdir.GAMMA_HOISTED_ROUNDS)]


def kernel_uniforms(key, rnd, i, bits):
    """The three uniforms entry ``i`` draws in round ``rnd`` in the gamma
    kernel (two for the normal, one for the test), from its lane's key:
    the words from the block's table below `GAMMA_HOISTED_ROUNDS`, from the
    entry's own fold chain past it, hashed with the entry's element offset
    and rounded in the draw's type (``(b + 0.5) 2^-bits``; in float32 the
    sum rounds)."""
    F = np.float32 if bits == 24 else float
    step = ((i + 1) * 0x9E3779B97F4A7C15) & M64
    words = (round_table(key)[rnd] if rnd < tdir.GAMMA_HOISTED_ROUNDS
             else round_words(key, rnd))
    return [float(F(F(F(mix(w + step) >> (64 - bits)) + F(0.5)) * F(2.0 ** -bits)))
            for w in words]


def test_gamma_round_table_is_the_lane_streams():
    """The hoisted table's words are the keys of `LaneRNG`'s folded streams
    of each round: ``fold(2r).fold(0)``, ``fold(2r).fold(1)`` (the normal)
    and ``fold(2r + 1)`` (the test)."""
    rng = LaneRNG.from_seeds([5, -9, 2**40, 0], "cpu").fold(11)
    for lane in range(rng.lanes):
        table = round_table(int(rng.keys[lane]))
        assert len(table) == tdir.GAMMA_HOISTED_ROUNDS == 8
        for rnd, words in enumerate(table):
            sub = rng.fold(2 * rnd)
            want = (sub.fold(0).keys, sub.fold(1).keys, rng.fold(2 * rnd + 1).keys)
            assert [w & M64 for w in map(int, (k[lane] for k in want))] == list(words)


@pytest.mark.parametrize("dtype,bits", [(torch.float32, 24), (F64, 53)])
def test_gamma_kernel_streams_are_the_lane_streams(dtype, bits):
    """The draws csrc/gamma_accept.cu derives per entry (the block's table
    of round words, or past it the entry's own fold chain, on 64-bit words)
    are `LaneRNG`'s: the uniforms behind a round's normal and its test,
    entry by entry."""
    rng = LaneRNG.from_seeds([5, -9, 2**40], "cpu").fold(3)
    shape = (3, 4, 5)
    for rnd in (0, 1, 7, 8, 12):
        sub = rng.fold(2 * rnd)
        want = [uniform(sub, shape, 0, dtype, "cpu"),
                uniform(sub, shape, 1, dtype, "cpu"),
                uniform(rng, shape, 2 * rnd + 1, dtype, "cpu")]
        for lane in range(3):
            for i in (0, 7, 19):
                got = kernel_uniforms(int(rng.keys[lane]), rnd, i, bits)
                assert got == [float(w[lane].reshape(-1)[i]) for w in want]


@pytest.mark.parametrize("L", [1, 2, 3, 112, 640, 5120])
def test_gamma_plan_covers_each_lane_once(L):
    """`gamma_plan`'s ranges cover every entry of a lane exactly once, none
    empty and none longer than `GAMMA_MAX_SPAN`, with the bounds the kernel
    checks; config 3's scout gets a block per lane (five entries a
    thread), `sample()`'s one lane 17 blocks (one entry a thread)."""
    for per_lane in (1, 2, 5, 31, 127, 128, 129, 640, 896, 2100, 2101, 5000,
                     100003):
        blocks, span, threads = tdir.gamma_plan(L, per_lane)
        assert 1 <= span <= tdir.GAMMA_MAX_SPAN and threads == tdir.GAMMA_THREADS
        assert threads % 32 == 0 and threads >= tdir.GAMMA_HOISTED_ROUNDS
        assert blocks * span >= per_lane > (blocks - 1) * span
        seen = np.zeros(per_lane, dtype=int)
        for k in range(blocks):
            lo, hi = k * span, min((k + 1) * span, per_lane)
            assert lo < hi
            seen[lo:hi] += 1
        assert (seen == 1).all()
    assert tdir.gamma_plan(640, 640) == (1, 640, 128)      # config 3's scout
    assert tdir.gamma_plan(1, 2100) == (17, 124, 128)      # sample()'s step


# -- the fold by a device step counter ------------------------------------

def test_fold_by_device_step_equals_host_int():
    rng = LaneRNG.from_seeds([3, 99, -7, 2**40, 0], "cpu")
    for step in range(6):
        want = rng.fold(step)
        for tag in (torch.tensor(step), torch.full((5,), step)):
            got = rng.fold(tag)
            assert torch.equal(got.keys, want.keys)
            assert torch.equal(got.uniform((4,), 1, F64),
                               want.uniform((4,), 1, F64))
    per_lane = rng.fold(torch.arange(5))
    for lane in range(5):
        assert per_lane.keys[lane] == rng.fold(lane).keys[lane]
    flag = torch.zeros((), dtype=torch.bool)
    shared = LaneRNG(rng.keys, flag)
    assert shared.fold(torch.tensor(2)).exhausted is flag
    assert shared[1:3].fold(4).exhausted is flag


# -- the in-place step against the previous loops -------------------------

@pytest.mark.parametrize("scout", [None, 2])
def test_sample_batch_equals_the_previous_loop(rouse, monkeypatch, scout):
    model, batch = rouse
    kw = dict(KW, scout_steps=scout, refine_top=2)
    got = sample_batch(model, batch, **kw, generator=gen(4))
    assert graphs.graphed("cpu") is False
    with monkeypatch.context() as m:
        previous(m)
        want = sample_batch(model, batch, **kw, generator=gen(4))
    assert_same(got, want)
    assert np.isfinite(got.evidence).all() and got.mom_ok.all()


def test_sample_batch_float32_equals_the_previous_loop(monkeypatch):
    model = bt.models.MultiStateRouse(6, 1.0, 5.0, d=2, localization_error=0.15,
                                      device="cpu", dtype=torch.float32)
    batch = model.trajectories_from_loopingprofiles(
        truths(B=3, T=24), generator=torch.Generator().manual_seed(1))
    kw = dict(k_max=2, steps_per_k=4, N=16, informed_init=True)
    got = sample_batch(model, batch, **kw, generator=gen(2))
    with monkeypatch.context() as m:
        previous(m)
        want = sample_batch(model, batch, **kw, generator=gen(2))
    assert_same(got, want, ("evidence", "evidence_se", "map_profiles", "mom_ok"))


def test_adaptive_equals_the_previous_loop(rouse, monkeypatch):
    model, batch = rouse
    got = adaptive.sample_batch_adaptive(model, batch, **AKW, generator=gen(6))
    with monkeypatch.context() as m:
        previous(m)
        want = adaptive.sample_batch_adaptive(model, batch, **AKW,
                                              generator=gen(6))
    assert_same(got, want)
    assert np.array_equal(got.steps, want.steps)
    assert np.array_equal(got.evals, want.evals) and got.rounds == want.rounds
    assert got.rounds >= 2


def test_ggm_sample_batch_equals_the_previous_loop(monkeypatch):
    GGM = bt.models.GenericGaussianModel
    model = GGM([[(GGM.MSD_function_twoLocusRouse(G=1, J=20), 0.0, 0)],
                 [(GGM.MSD_function_twoLocusRouse(G=1, J=0.5), 0.0, 0)]],
                device="cpu", dtype=F64)
    prof = truths(B=3, T=16)
    trajs = [model.trajectory_from_loopingprofile(p, rng=np.random.default_rng(b))
             for b, p in enumerate(prof)]
    batch = tbatch.stack_trajectories(trajs)
    kw = dict(k_max=2, steps_per_k=4, N=16)
    got = sample_batch(model, batch, **kw, generator=gen(8))
    with monkeypatch.context() as m:
        previous(m)
        want = sample_batch(model, batch, **kw, generator=gen(8))
    assert_same(got, want, ("evidence", "evidence_se", "map_profiles", "mom_ok"))


def test_run_lanes_counts_on_the_host(rouse):
    model, batch = rouse
    tbatch.run_lanes.steps = tbatch.run_lanes.lane_steps = 0
    sample_batch(model, batch, **dict(KW, scout_steps=2, refine_top=2),
                 generator=gen(4))
    # scout: 4 k x 5 rows for 2 steps; refine: 2 x 5 rows for 4 steps
    assert tbatch.run_lanes.steps == 2 + 4
    assert tbatch.run_lanes.lane_steps == 20 * 2 + 10 * 4


# -- the graph path's buffers and cache, with a stand-in capture ----------

def test_graph_path_equals_eager(rouse, monkeypatch):
    """Step `start` eagerly where nothing is cached, the rest as replays on
    the graph's own buffers (copied in and out): the same bits as the eager
    loop; a second call replays every step of a cached graph; another
    likelihood closure frees the graphs of the first."""
    model, batch = rouse
    kw = dict(KW, scout_steps=2, refine_top=2)
    want = sample_batch(model, batch, **kw, generator=gen(4))
    want_ad = adaptive.sample_batch_adaptive(model, batch, **AKW,
                                             generator=gen(6))
    with monkeypatch.context() as m:
        stand_in_graphs(m)
        c0, r0 = graphs.replay.captures, graphs.replay.replays
        got = sample_batch(model, batch, **kw, generator=gen(4))
        assert graphs.replay.captures == c0 + 2          # scout, refine
        assert graphs.replay.replays == r0 + (2 - 1) + (4 - 1)
        again = sample_batch(model, batch, **kw, generator=gen(4))
        assert graphs.replay.captures == c0 + 2
        assert graphs.replay.replays == r0 + 4 + 6
        got_ad = adaptive.sample_batch_adaptive(model, batch, **AKW,
                                                generator=gen(6))
        kinds = {k[0] for k in graphs._GRAPHS}
        assert kinds == {"lanes", "slots"}
        first = {k[1] for k in graphs._GRAPHS}
        other = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3,
                                          localization_error=0.2,
                                          device="cpu", dtype=F64)
        sample_batch(other, batch, **KW, generator=gen(4))
        assert graphs._GRAPHS and not first & {k[1] for k in graphs._GRAPHS}
        graphs.clear()
    assert_same(got, want)
    assert_same(again, want)
    assert_same(got_ad, want_ad)
    assert np.array_equal(got_ad.steps, want_ad.steps)


def test_graph_cache_is_bounded(monkeypatch):
    with monkeypatch.context() as m:
        stand_in_graphs(m)
        m.setattr(graphs, "_GRAPHS_MAX", 2)
        calls = []

        def step(mutable, scratch, owner, x):
            mutable[0].add_(x)
            calls.append(1)

        owner = object()
        for size in (1, 2, 3):
            buf = [torch.zeros(size)]
            graphs.replay("t", owner, step, buf, (owner, torch.ones(size)), 3)
            assert torch.equal(buf[0], torch.full((size,), 3.0))
        assert len(graphs._GRAPHS) == 2 and len(calls) == 9
        assert graphs.cached("t", owner, [torch.zeros(3)],
                             (owner, torch.ones(3)))
        assert not graphs.cached("t", owner, [torch.zeros(1)],
                                 (owner, torch.ones(1)))
        graphs.clear()


def test_replay_counts_every_registered_counter(monkeypatch):
    """A replay adds what its capture counted to every counter of
    `ops.counters`, a counter registered after the graphs module too; the
    capture's own counts are taken back."""
    def kernel():
        kernel.launches += 1

    with monkeypatch.context() as m:
        stand_in_graphs(m)
        # a capture runs the step's Python once; its replays launch only
        m.setattr(graphs, "_capture", lambda fn: (fn(), lambda: None)[1])
        m.setattr(counters, "COUNTERS", dict(counters.COUNTERS))
        counters.register("test_kernel", kernel, "launches")
        before = counters.read()

        def step(mutable, scratch, owner):
            kernel()
            kernel()

        owner = object()
        graphs.replay("t", owner, step, [torch.zeros(1)], (owner,), 5)
        assert kernel.launches == 10 and graphs.replay.captures > 0
        after = counters.read()
        # the graphs' own counters count the capture, the replays and the
        # copies once each: none of them moves inside a step
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
            == {"test_kernel": 10, "graphs.captures": 1, "graphs.replays": 5,
                "graphs.copies": 2}
        graphs.clear()


def test_counter_registry_names_every_kernel():
    """Every kernel wrapper and plain version registers its counter where it
    is defined, and the benchmark script's counters are the registry's."""
    import bench_torch
    from bild_tpu_torch.ops import kalman, kalman_dense, kalman_sym

    assert counters.COUNTERS["cfc_solve"] == (tcfc.solve_marginals, "launches")
    assert counters.COUNTERS["plain_cfc"] == (tcfc._solve_marginals, "calls")
    assert counters.COUNTERS["gamma_accept"] == (tdir.gamma_accept, "launches")
    assert counters.COUNTERS["plain_gamma"] == (tdir._gamma_accept, "calls")
    assert counters.COUNTERS["kalman_sym_split"] == (
        kalman_sym.msrouse_logL_sym, "split_launches")
    assert counters.COUNTERS["plain_dense"] == (
        kalman_dense.msrouse_logL_dense_torch, "calls")
    assert counters.COUNTERS["plain_torch"] == (kalman.msrouse_logL_batch, "calls")
    for name, entry in bench_torch.counters().items():
        assert counters.COUNTERS[name] == entry, name
    # the benchmark script and the smoke script read the whole registry:
    # no list of their own that could miss a kernel
    assert dict(bench_torch.counters()) == counters.COUNTERS
    assert set(counters.COUNTERS) >= {"gamma_accept", "plain_gamma",
                                      "cfc_solve", "plain_cfc"}
    import chip_smoke
    assert chip_smoke.counters is counters
    assert "**counters.read()" in chip_smoke.CLI_RUNNER
    with open(chip_smoke.__file__) as fh:
        src = fh.read()
    assert "read_counts" not in src and "reset_counts" not in src


def test_eager_attribute_and_cpu():
    assert graphs._EAGER is False
    assert not graphs.graphed("cpu") and graphs.graphed("cuda")
    graphs._EAGER = True
    try:
        assert not graphs.graphed("cuda")
    finally:
        graphs._EAGER = False


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("selector", ["auto", "sym", "dense", "ggm"])
def test_cuda_graphed_equals_eager(cuda, selector):
    """The lockstep and adaptive runners on the card: replays of a captured
    step (a capture that fails on any host read) against the eager loop,
    bit for bit, through the selected kernel and the CFC kernel."""
    from bild_tpu_torch.ops import kalman_dense, kalman_sym
    if selector == "ggm":
        GGM = bt.models.GenericGaussianModel
        model = GGM([[(GGM.MSD_function_twoLocusRouse(G=1, J=20), 0.0, 0)],
                     [(GGM.MSD_function_twoLocusRouse(G=1, J=0.5), 0.0, 0)]],
                    device=cuda, dtype=torch.float32)
        batch = tbatch.stack_trajectories(
            [model.trajectory_from_loopingprofile(p, rng=np.random.default_rng(b))
             for b, p in enumerate(truths(T=24))])
    else:
        model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3,
                                          localization_error=0.1, device=cuda,
                                          dtype=torch.float32)
        batch = model.trajectories_from_loopingprofiles(
            truths(), generator=torch.Generator(device=cuda).manual_seed(3))
    old = bt.config.rouse_kernel()
    bt.config.set_rouse_kernel("sym" if selector == "ggm" else selector)
    kw = dict(KW, scout_steps=2, refine_top=2)
    out, counts = {}, {}
    try:
        for eager in (True, False):
            graphs._EAGER = eager
            before = (graphs.replay.captures, graphs.replay.replays,
                      tcfc.solve_marginals.launches,
                      tdir.gamma_accept.launches,
                      kalman_sym.msrouse_logL_sym.launches
                      + kalman_dense.msrouse_logL_dense.launches)
            out[eager] = (sample_batch(model, batch, **kw, generator=gen(4)),
                          adaptive.sample_batch_adaptive(model, batch, **AKW,
                                                         generator=gen(6)))
            counts[eager] = [a - b for a, b in zip(
                (graphs.replay.captures, graphs.replay.replays,
                 tcfc.solve_marginals.launches,
                 tdir.gamma_accept.launches,
                 kalman_sym.msrouse_logL_sym.launches
                 + kalman_dense.msrouse_logL_dense.launches), before)]
    finally:
        graphs._EAGER = False
        bt.config.set_rouse_kernel(old)
        graphs.clear()
    for a, b in zip(out[True], out[False]):
        assert_same(a, b)
    assert counts[True][:2] == [0, 0] and min(counts[False][:2]) > 0
    # a replay counts the launches of the step it replays
    assert counts[True][2:] == counts[False][2:]
    assert min(counts[True][2:4]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_cuda_gamma_kernel_matches_plain(cuda, dtype, monkeypatch):
    """csrc/gamma_accept.cu against its plain rounds on the card, at shapes
    from 0.05 to 1e10 (float32 needs tens of rounds there): within 4 ulp,
    with entries that the plain loop leaves after 4 rounds (float32) or 1
    (float64); with the cap cut to one round the flag is set. Also at lane
    lengths that `gamma_plan` cuts into ranges that do not divide them
    (2,101 entries: 16 ranges of 124 and one of 117), at lanes of one
    entry, and with ``c`` scaled by 4 (a draw the test rejects more often:
    entries past the block's `GAMMA_HOISTED_ROUNDS` hoisted rounds in both
    types)."""
    def held(d, c, streams):
        flag = torch.zeros((), dtype=torch.bool, device=cuda)
        launches = tdir.gamma_accept.launches
        got = tdir.gamma_accept(d, c, LaneRNG(streams.keys, flag))
        assert tdir.gamma_accept.launches == launches + 1 and not bool(flag)
        want = tdir._gamma_accept(d, c, LaneRNG(streams.keys))
        ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) - want.abs()
        assert float(((got - want).abs() / ulp).max()) <= 4
        assert torch.equal(got.isfinite(), want.isfinite())

    rng = np.random.default_rng(3)
    alpha = torch.as_tensor(np.concatenate(
        [rng.uniform(0.05, 8, (4, 3000)), 10 ** rng.uniform(5, 10, (4, 1000))],
        axis=1), dtype=dtype, device=cuda)
    a = torch.where(alpha < 1, alpha + 1, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    streams = LaneRNG.from_seeds([1, 2, 3, 4], cuda).fold(7)
    held(d, c, streams)
    short = torch.zeros((), dtype=torch.bool, device=cuda)
    tdir._gamma_accept(d, c, LaneRNG(streams.keys, short),
                       max_rounds=4 if dtype == torch.float32 else 1)
    assert bool(short)
    for L, per_lane, scale in ((3, 2101, 1.0), (5, 1, 1.0), (640, 1, 1.0),
                               (3, 2101, 4.0), (1, 640, 4.0)):
        a = torch.as_tensor(rng.uniform(1, 8, (L, per_lane)), dtype=dtype,
                            device=cuda)
        d = a - 1.0 / 3.0
        c = scale / torch.sqrt(9.0 * d)
        lanes = LaneRNG.from_seeds(list(range(L)), cuda).fold(per_lane)
        held(d, c, lanes)
        if scale > 1:
            past = torch.zeros((), dtype=torch.bool, device=cuda)
            tdir._gamma_accept(d, c, LaneRNG(lanes.keys, past),
                               max_rounds=tdir.GAMMA_HOISTED_ROUNDS)
            assert bool(past)
    monkeypatch.setattr(tdir, "GAMMA_MAX_ROUNDS", 1)
    flag = torch.zeros((), dtype=torch.bool, device=cuda)
    tdir.gamma_accept(d, c, LaneRNG(lanes.keys, flag))
    assert bool(flag)
