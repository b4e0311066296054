"""`sample()`'s step as the lockstep runner's step at one lane
(bild_tpu_torch.amis.FixedkSampler): steps(n) against n x steps(1) and
against `run_lanes` at L=1 on the same key, one shared graph per step
shape for a whole `sample()` (driven on the CPU with a stand-in capture),
a CFC divergence inside steps(n), a user-defined model's eager step on the
sampler's stream, and the checkpoint of the stream key. On the card,
`sample()` graphed against eager bit for bit (marked `cuda`)."""
import math

import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.amis import dirichlet as tdir
from bild_tpu_torch.amis import sampler as tsampler
from bild_tpu_torch.amis.cfc import CFC
from bild_tpu_torch.amis.sampler import AmisState, FixedkSampler, draw_seed
from bild_tpu_torch.lanes import LaneRNG
from bild_tpu_torch.ops import counters
from bild_tpu_torch.parallel import graphs
from bild_tpu_torch.parallel.batch import run_lanes, run_steps
from bild_tpu_torch.utils.checkpoint import load_results, save_results

torch.set_num_threads(1)       # one torch thread per test worker

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
SKW = {"N": 24, "max_fev": 1200}          # sampler_kw of the sample() runs


def gen(seed):
    return torch.Generator().manual_seed(seed)


def model_and_traj(kind, seed=0, T=30):
    """A small float64 CPU model and a trajectory with a loop in it."""
    true = np.zeros(T, dtype=int)
    true[T // 3: 2 * T // 3] = 1
    if kind == "ggm":
        G = bt.models.GenericGaussianModel
        model = G([[(G.MSD_function_twoLocusRouse(G=1.0, J=20.0), 0.0, 0)],
                   [(G.MSD_function_twoLocusRouse(G=1.0, J=0.5), 0.0, 0)]],
                  **CPU)
        traj = model.trajectory_from_loopingprofile(
            true, rng=np.random.default_rng(seed))
    else:
        model = bt.models.MultiStateRouse(6, 1.0, 5.0, d=3,
                                          localization_error=0.1, **CPU)
        traj = model.trajectory_from_loopingprofile(true, generator=gen(seed))
    return model, traj


def lane_arrays(s):
    return [t.clone() for t in s._lane.tensors()]


def same_tensors(a, b):
    """Bit for bit (NaN where NaN)."""
    def same(x, y):
        if not x.is_floating_point():
            return torch.equal(x, y)
        return (torch.equal(x.isnan(), y.isnan())
                and torch.equal(x.nan_to_num(), y.nan_to_num()))
    return all(same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("informed", [False, True])
@pytest.mark.parametrize("kind", ["rouse", "ggm"])
def test_steps_n_equal_n_single_steps(kind, informed):
    """`bild_tpu`'s promise (`FixedkSampler.steps`): ``steps(n)`` samples
    as n calls of ``steps(1)``, bit for bit, informed injection included."""
    model, traj = model_and_traj(kind)
    a, b = (FixedkSampler(traj, model, k=2, N=16, max_fev=400, k_pad=3,
                          informed_init=informed, generator=gen(5))
            for _ in range(2))
    if informed:
        assert a._informed is not None and bool(a._lane_informed[2])
    assert a.steps(5) == 5
    for _ in range(5):
        assert b.steps(1) == 1
    assert a.evidences == b.evidences and len(a.evidences) == 5
    assert a.n_steps_host == b.n_steps_host == 5
    assert same_tensors(lane_arrays(a), lane_arrays(b))
    sa, sb = a.state.to_numpy(), b.state.to_numpy()
    assert sa["n_steps"] == 5
    assert all(np.array_equal(sa[f], sb[f],
                              equal_nan=np.asarray(sa[f]).dtype.kind == "f")
               for f in sa)
    if informed:     # the second mixture component is the guess
        np.testing.assert_array_equal(a.parameters[1][0],
                                      a._informed[0].numpy())


@pytest.mark.parametrize("kind", ["rouse", "ggm"])
def test_sampler_steps_equal_run_lanes(kind):
    """The sampler's steps are `run_lanes` at one lane: the same key (one
    draw of the generator), the same fresh state, the model's lane
    likelihood at the padded slot count, bit for bit."""
    model, traj = model_and_traj(kind)
    k, k_pad, N, steps = 2, 4, 16, 4
    s = FixedkSampler(traj, model, k=k, N=N, max_fev=400, k_pad=k_pad,
                      generator=gen(3))
    s.steps(steps)

    K1, T = k_pad + 1, len(traj)
    cfc = CFC(model.transitions)
    n = cfc.n
    logp0 = np.full((1, n, K1), -math.log(n))
    logp0[0, :, : k + 1] = cfc.logp_uniform(k)
    state = AmisState.create(s.S, N, K1 - 1, n, np.ones((1, K1)), logp0,
                             lanes=1, **CPU)
    lane_data, logL_fn = model.lockstep_fns_lane(traj, max_intervals=K1)
    assert logL_fn is s._logL_fn
    rng = LaneRNG.from_seeds([draw_seed(gen(3))], "cpu")
    logprior = (sum(math.log(i + 1) for i in range(k))
                - cfc.N_total(k, log=True))
    run_lanes(logL_fn, lane_data, state, rng,
              torch.as_tensor(model.transitions), torch.arange(K1)[None] < k + 1,
              torch.tensor([logprior], dtype=F64), N * 1e-2, N * 1e-3, N=N, T=T,
              start=0, stop=steps)
    assert same_tensors(state.tensors(), s._lane.tensors())
    np.testing.assert_array_equal(state.evidences[0, :steps].numpy(),
                                  np.array(s.evidences))


def sample_results(model, traj, seed):
    return bt.sample(traj, model, k_max=3, init_runs=4, sampler_kw=SKW,
                     generator=gen(seed))


def assert_same_results(a, b):
    assert len(a.samplers) == len(b.samplers)
    for x, y in zip(a.samplers, b.samplers):
        assert x.evidences == y.evidences
        if hasattr(x, "_lane"):
            assert same_tensors(x._lane.tensors(), y._lane.tensors())
    np.testing.assert_array_equal(np.asarray(a.best_profile()[:]),
                                  np.asarray(b.best_profile()[:]))
    np.testing.assert_array_equal(a.log_marginal_posterior(dE="average"),
                                  b.log_marginal_posterior(dE="average"))
    np.testing.assert_array_equal(a.log["k"], b.log["k"])


@pytest.mark.parametrize("kind", ["rouse", "ggm"])
def test_sample_replays_one_graph(kind, monkeypatch):
    """A whole `sample()` through the graph path (a stand-in capture on the
    CPU) has the eager bits and captures one graph: every sampler shares
    the model's closure, its step shape (the padded slot count) and the
    graph, with the per-k numbers among the graph's inputs. A second
    `sample()` on another trajectory of the same length captures none."""
    model, traj = model_and_traj(kind)
    _, other = model_and_traj(kind, seed=1)
    eager = sample_results(model, traj, 7)
    graphs.clear()
    monkeypatch.setattr(graphs, "graphed", lambda device: True)
    monkeypatch.setattr(graphs, "_capture", lambda fn: fn)
    try:
        c0, r0, s0 = graphs.replay.captures, graphs.replay.replays, run_steps.steps
        k0, calls, real = graphs.replay.copies, [], FixedkSampler.steps

        def counting(self, n):
            ran = real(self, n)
            calls.append(ran > 0)
            return ran

        monkeypatch.setattr(FixedkSampler, "steps", counting)
        graphed = sample_results(model, traj, 7)
        c1, r1 = graphs.replay.captures, graphs.replay.replays
        assert c1 - c0 == 1
        amis_steps = sum(s.n_steps_host for s in graphed.samplers)
        assert run_steps.steps - s0 == amis_steps
        assert r1 - r0 == amis_steps - 1        # the first step ran eagerly
        assert len(graphs._GRAPHS) == 1
        # every steps(n) call copies the inputs in and the state in and out
        (graph,) = graphs._GRAPHS.values()
        assert graphs.replay.copies - k0 == sum(calls) * (
            len(graph.inputs) + 2 * len(graph.mutable))
        again = sample_results(model, other, 8)
        assert graphs.replay.captures == c1
        assert graphs.replay.replays - r1 == sum(s.n_steps_host
                                                 for s in again.samplers)
    finally:
        graphs.clear()
    assert_same_results(graphed, eager)
    assert sum(s.n_steps_host > 0 for s in graphed.samplers) >= 2


def test_divergence_inside_steps_keeps_earlier_evidences(monkeypatch):
    """A CFC fixed point that fails at step j of ``steps(n)``: the evidences
    of the steps before j are kept (the same bits as a run without the
    failure), the later ones dropped, the step count advanced, and
    `RuntimeError` raised, as `bild_tpu`'s fused steps do."""
    model, traj = model_and_traj("rouse")
    ref, s = (FixedkSampler(traj, model, k=2, N=16, max_fev=400,
                            generator=gen(9)) for _ in range(2))
    ref.steps(7)
    s.steps(2)
    real, calls = tsampler.cfc_estimate, []

    def failing(*args, **kw):
        new_logp, conv = real(*args, **kw)
        calls.append(None)
        if len(calls) == 3:                     # the third step of the call
            conv = torch.zeros_like(conv)
        return new_logp, conv

    monkeypatch.setattr(tsampler, "cfc_estimate", failing)
    with pytest.raises(RuntimeError, match="did not converge"):
        s.steps(5)
    assert len(calls) == 5 and s.n_steps_host == 7
    assert s.evidences == ref.evidences[:4]
    assert not bool(s._lane.mom_ok[0])
    with pytest.raises(RuntimeError, match="did not converge"):
        s.steps(1)                              # it stays diverged
    assert len(s.evidences) == 4


class NumpyModel:
    """A user-defined two-state model with only ``nStates``,
    ``transitions`` and a ``logL_batch`` that returns numpy."""

    def __init__(self):
        self.nStates = 2
        self.transitions = ~np.eye(2, dtype=bool)
        self.device, self.dtype = "cpu", F64
        self.calls = 0

    def logL_batch(self, profiles, traj):
        self.calls += 1
        y = traj.data[:, 0].numpy()
        mu = np.array([0.0, 3.0])[profiles.numpy()]
        return (-0.5 * ((y[None] - mu) ** 2 + math.log(2 * math.pi))).sum(1)


def test_user_model_steps_eagerly_on_the_stream(monkeypatch):
    """A model without ``lockstep_fns`` runs the same step eagerly (no
    `run_steps`, no graph) on the sampler's stream: every Dirichlet draw
    goes through `dirichlet.gamma_accept` on lane streams, never through
    `standard_gamma`'s `torch.Generator` loop; ``steps(n)`` equals n x
    ``steps(1)``."""
    rng = np.random.default_rng(4)
    true = np.zeros(20, dtype=int)
    true[8:14] = 1
    y = np.array([0.0, 3.0])[true] + 0.6 * rng.normal(size=20)
    traj = bt.Trajectory.create(y[:, None], dtype=F64)
    lane_calls, sources = [], []
    accept, plain = tdir.gamma_accept, tdir._gamma_accept

    def spy_accept(d, c, generator):
        lane_calls.append(type(generator))
        return accept(d, c, generator)

    def spy_plain(d, c, generator, max_rounds=None):
        sources.append(type(generator))
        return plain(d, c, generator, max_rounds)

    spy_plain.calls = 0                 # the plain loop counts on its name
    monkeypatch.setattr(tdir, "gamma_accept", spy_accept)
    monkeypatch.setattr(tdir, "_gamma_accept", spy_plain)
    model = NumpyModel()
    a, b = (FixedkSampler(traj, model, k=2, N=16, max_fev=400,
                          max_fcomplete=0, generator=gen(2)) for _ in range(2))
    steps0 = run_steps.steps
    assert a.steps(4) == 4 and model.calls == 4
    for _ in range(4):
        b.step()
    assert run_steps.steps == steps0
    assert a.evidences == b.evidences
    assert same_tensors(lane_arrays(a), lane_arrays(b))
    assert len(lane_calls) == 8 and set(lane_calls) == {LaneRNG}
    assert sources and set(sources) == {LaneRNG}
    assert a.state.logLs.dtype == F64
    assert np.all(np.isfinite(np.array(a.evidences)[:, :2]))


@pytest.mark.parametrize("kind", ["user", "rouse"])
def test_only_a_lone_eager_step_drops_lane_exact_sums(kind, monkeypatch):
    """The step of a model without ``lockstep_fns`` (eager, never shared
    with another lane) asks `lane_step` for PyTorch's own reductions; a
    built-in model's step, which the graph shares, for the lane-exact
    ones."""
    from bild_tpu_torch.parallel import batch

    if kind == "user":
        model = NumpyModel()
        traj = bt.Trajectory.create(np.zeros((20, 1)), dtype=F64)
    else:
        model, traj = model_and_traj("rouse")
    seen, real = [], batch.lane_step

    def spy(*args):
        seen.append(args[14] if len(args) > 14 else True)
        return real(*args)

    monkeypatch.setattr(batch, "lane_step", spy)
    s = FixedkSampler(traj, model, k=2, N=16, max_fev=400, max_fcomplete=0,
                      generator=gen(5))
    assert s.steps(2) == 2
    assert seen == [kind == "rouse"] * 2


def test_rouse_single_is_the_lane_closure():
    """`MultiStateRouse.logL_batch` goes through `lockstep_fns_single`, a
    wrapper of the lane closure that the sampler's step calls: the same
    bits as that closure on a lane of one, one wrapper for trajectories of
    other noise (which travels in ``lane_data``)."""
    _, noisy = model_and_traj("rouse")
    model = bt.models.MultiStateRouse(6, 1.0, 5.0, d=3, **CPU)
    traj, other = (bt.Trajectory(noisy.data, noisy.valid,
                                 localization_error=np.full(3, err))
                   for err in (0.1, 0.3))
    profiles = np.random.default_rng(3).integers(0, 2, size=(5, len(traj)))
    lane_data, lane_fn = model.lockstep_fns_lane(traj)
    want = lane_fn(torch.as_tensor(profiles)[None], lane_data)[0]
    assert torch.equal(model.logL_batch(profiles, traj), want)
    per_traj, single = model.lockstep_fns_single(traj)
    per_other, single_other = model.lockstep_fns_single(other)
    assert single is single_other
    assert torch.equal(single(profiles, per_traj), want)
    assert not torch.equal(single(profiles, per_other), want)
    assert torch.equal(single(profiles, per_other),
                       model.logL_batch(profiles, other))


def test_checkpoint_resumes_on_the_stream_key(tmp_path):
    """`save_results` stores each sampler's int64 stream key; a loaded
    sampler's next steps equal the uninterrupted ones bit for bit (from
    the restored device step count). A checkpoint holding a
    `torch.Generator` state (the format before the stream) raises."""
    model, traj = model_and_traj("rouse")
    res = sample_results(model, traj, 3)
    path = str(tmp_path / "res.npz")
    save_results(path, res)
    loaded = load_results(path, model)
    i = next(i for i, s in enumerate(res.samplers) if not s.exhausted)
    with np.load(path) as zf:
        arrays = dict(zf)
    assert arrays[f"s{i}_key"].dtype == np.int64
    assert torch.equal(loaded.samplers[i]._rng.keys, res.samplers[i]._rng.keys)
    assert torch.equal(loaded.samplers[i]._lane.n_steps,
                       res.samplers[i]._lane.n_steps)
    for s in (res.samplers[i], loaded.samplers[i]):
        assert s.steps(2) == 2
    assert res.samplers[i].evidences == loaded.samplers[i].evidences
    assert same_tensors(res.samplers[i]._lane.tensors(),
                        loaded.samplers[i]._lane.tensors())

    arrays[f"s{i}_key"] = torch.Generator().get_state().numpy()
    old = str(tmp_path / "old.npz")
    np.savez_compressed(old, **arrays)
    with pytest.raises(ValueError, match="int64 stream key"):
        load_results(old, model)


def test_every_sampler_has_its_own_key():
    """`sample()` spawns one generator per sampler, and each sampler keys
    its stream by one draw of it: no two samplers share a stream."""
    model, traj = model_and_traj("rouse")
    res = sample_results(model, traj, 11)
    keys = [int(s._rng.keys[0]) for s in res.samplers]
    assert len(keys) >= 3 and len(set(keys)) == len(keys)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("selector", ["auto", "sym", "dense", "ggm"])
def test_cuda_sample_graphed_equals_eager(cuda, selector):
    """`sample()` on the card: the model's step graph replayed (one
    capture) against the eager step, bit for bit, through the gamma and
    CFC kernels and no plain version."""
    if selector == "ggm":
        G = bt.models.GenericGaussianModel
        model = G([[(G.MSD_function_twoLocusRouse(G=1.0, J=20.0), 0.0, 0)],
                   [(G.MSD_function_twoLocusRouse(G=1.0, J=0.5), 0.0, 0)]],
                  device=cuda, dtype=torch.float32)
        true = np.zeros(30, dtype=int)
        true[10:20] = 1
        traj = model.trajectory_from_loopingprofile(
            true, rng=np.random.default_rng(0))
    else:
        model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3,
                                          localization_error=0.1, device=cuda,
                                          dtype=torch.float32)
        true = np.zeros(60, dtype=int)
        true[20:40] = 1
        traj = model.trajectory_from_loopingprofile(
            true, generator=torch.Generator(device=cuda).manual_seed(0))
    old = bt.config.rouse_kernel()
    bt.config.set_rouse_kernel("sym" if selector == "ggm" else selector)
    out, caps, ran = {}, {}, {}
    try:
        for eager in (True, False):
            graphs._EAGER = eager
            graphs.clear()
            counters.reset()
            c0 = graphs.replay.captures
            out[eager] = bt.sample(
                traj, model, k_max=4, sampler_kw={"N": 64},
                generator=torch.Generator(device=cuda).manual_seed(7))
            caps[eager] = graphs.replay.captures - c0
            ran[eager] = counters.read()
    finally:
        graphs._EAGER = False
        bt.config.set_rouse_kernel(old)
        graphs.clear()
    assert_same_results(out[True], out[False])
    assert caps == {True: 0, False: 1}
    # every counter but the graphs' own (captures, replays, copies), which
    # count the graph itself: a replay counts the launches of its step
    ran = {mode: {k: v for k, v in r.items() if not k.startswith("graphs.")}
           for mode, r in ran.items()}
    assert ran[True] == ran[False]
    assert ran[False]["gamma_accept"] > 0 and ran[False]["cfc_solve"] > 0
    assert not any(v for k, v in ran[False].items() if k.startswith("plain"))


@pytest.mark.cuda
def test_cuda_capture_refuses_a_host_read(cuda):
    """A sampler step that reads a value back to the host fails to capture
    (the capture runs under ``set_sync_debug_mode("error")``) and raises:
    no quiet fallback to the eager step."""
    model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3, localization_error=0.1,
                                      device=cuda, dtype=torch.float32)
    true = np.zeros(60, dtype=int)
    true[20:40] = 1
    traj = model.trajectory_from_loopingprofile(
        true, generator=torch.Generator(device=cuda).manual_seed(0))
    s = FixedkSampler(traj, model, k=3, N=32,
                      generator=torch.Generator(device=cuda).manual_seed(1))
    real = s._logL_fn

    def reading(profiles, lane_data):
        float(profiles.sum())
        return real(profiles, lane_data)

    s._logL_fn = reading
    graphs.clear()
    replays = graphs.replay.replays
    try:
        with pytest.raises(RuntimeError):
            s.steps(3)
    finally:
        graphs.clear()
    assert graphs.replay.replays == replays
