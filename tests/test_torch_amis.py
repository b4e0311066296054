"""bild_tpu_torch.amis against bild_tpu.amis: the Dirichlet and CFC
densities and estimates, and one AMIS update on the same state and sample
block (float64, rtol 1e-10); plus distribution checks of the samplers,
whose random streams differ from jax.random by design."""
import functools
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu.amis import cfc as jcfc
from bild_tpu.amis import dirichlet as jdir
from bild_tpu.amis import sampler as jsam
from bild_tpu_torch.amis import cfc as tcfc
from bild_tpu_torch.amis import dirichlet as tdir
from bild_tpu_torch.amis import sampler as tsam
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

RTOL = 1e-10
F64 = torch.float64


def T_(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def assert_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=RTOL, atol=1e-12)


TRANSITIONS = {
    "n=2": ~np.eye(2, dtype=bool),
    "n=3": ~np.eye(3, dtype=bool),
    "n=3 chain": np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]], dtype=bool),
}


@pytest.mark.parametrize("padded", [False, True])
def test_dirichlet_logpdf(rng, padded):
    K = 6
    a = np.array([0.3, 1.0, 2.5, 0.7, 4.0, 1.0])
    ss = rng.dirichlet(np.ones(K), size=50)
    ss[3, 0] = ss[4, 1] = ss[5, 2] = 0.0      # zero coordinates: +inf, 0, -inf
    active = np.arange(K) < 4 if padded else None
    act_t = None if active is None else T_(active)
    act_j = None if active is None else jnp.asarray(active)
    got = tdir.dirichlet_logpdf(T_(a), T_(ss), active=act_t)
    assert_close(got, jdir.dirichlet_logpdf(jnp.asarray(a), jnp.asarray(ss),
                                            active=act_j))
    # a leading parameter axis evaluates several proposals at once
    a2 = np.stack([a, a[::-1]])
    got2 = tdir.dirichlet_logpdf(T_(a2), T_(ss), active=act_t)
    for i in range(2):
        assert_close(got2[i], jdir.dirichlet_logpdf(
            jnp.asarray(a2[i]), jnp.asarray(ss), active=act_j))


@pytest.mark.parametrize("padded", [False, True])
def test_dirichlet_estimate(rng, padded):
    K = 5
    ss = rng.dirichlet([2.0, 3.0, 1.0, 4.0, 2.0], size=400)
    lw = rng.normal(size=400)
    lw[7] = -np.inf
    active = np.arange(K) < 3 if padded else None
    if padded:
        ss[:, 3:] = 0.0
        ss /= ss.sum(1, keepdims=True)
    got = tdir.dirichlet_estimate(T_(ss), T_(lw),
                                  active=None if active is None else T_(active))
    want = jdir.dirichlet_estimate(jnp.asarray(ss), jnp.asarray(lw),
                                   active=None if active is None else jnp.asarray(active))
    assert_close(got, want)


def test_dirichlet_estimate_degenerate():
    ss = np.tile([[0.2, 0.8]], (10, 1))
    got = tdir.dirichlet_estimate(T_(ss), T_(np.zeros(10)))
    assert_close(got, jdir.dirichlet_estimate(jnp.asarray(ss), jnp.zeros(10)))


@pytest.mark.parametrize("tname", list(TRANSITIONS))
@pytest.mark.parametrize("padded", [False, True])
def test_cfc_logpmf(rng, tname, padded):
    tr = TRANSITIONS[tname]
    n, K = tr.shape[0], 5
    logp = np.log(rng.dirichlet(np.ones(n), size=K).T)
    logp[0, 2] = -np.inf
    thetas = rng.integers(0, n, size=(80, K))
    active = np.arange(K) < 3 if padded else None
    got = tcfc.cfc_logpmf(T_(logp), T_(thetas), T_(tr),
                          active=None if active is None else T_(active))
    want = jcfc.cfc_logpmf(jnp.asarray(logp), jnp.asarray(thetas),
                           jnp.asarray(tr),
                           active=None if active is None else jnp.asarray(active))
    assert_close(got, want)


@pytest.mark.parametrize("tname", list(TRANSITIONS))
@pytest.mark.parametrize("padded", [False, True])
def test_cfc_estimate(rng, tname, padded):
    tr = TRANSITIONS[tname]
    n, K = tr.shape[0], 4
    thetas = jcfc.CFC(tr).full_sample(K - 1)
    thetas = thetas[rng.integers(0, len(thetas), size=300)]
    lw = rng.normal(size=300)
    active = np.arange(K) < 3 if padded else None
    got, conv = tcfc.cfc_estimate(T_(thetas), T_(lw), T_(tr), n,
                                  active=None if active is None else T_(active))
    want, jconv = jcfc.cfc_estimate(
        jnp.asarray(thetas), jnp.asarray(lw), jnp.asarray(tr), n,
        active=None if active is None else jnp.asarray(active))
    assert_close(got, want)
    assert bool(conv) == bool(jconv)


@pytest.mark.parametrize("tname", list(TRANSITIONS))
@pytest.mark.parametrize("k", [0, 1, 4])
def test_cfc_host_counting(tname, k):
    tr = TRANSITIONS[tname]
    a, b = tcfc.CFC(tr), jcfc.CFC(tr)
    assert a.N_total(k) == b.N_total(k)
    np.testing.assert_array_equal(a.full_sample(k), b.full_sample(k))
    np.testing.assert_allclose(a.uniform_marginals(k), b.uniform_marginals(k))
    np.testing.assert_allclose(a.logp_uniform(k), b.logp_uniform(k), rtol=RTOL)


def _jax_state(rng, S, N, K, n, k_act, steps, tr, padded):
    """A bild_tpu AmisState after `steps` updates on random blocks."""
    active = jnp.arange(K) < k_act + 1 if padded else None
    logp0 = np.full((n, K), -np.log(n))
    logp0[:, :k_act + 1] = jcfc.CFC(tr).logp_uniform(k_act)
    st = jsam.AmisState.create(S, N, K - 1, n, jnp.ones(K), jnp.asarray(logp0))
    key = jax.random.key(3)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        ss, th, _ = jsam.amis_propose(st, sub, jnp.asarray(tr), N=N, T=20,
                                      active=active)
        lls = jnp.asarray(rng.normal(size=N) * 5 - 50)
        st, _ = jsam.amis_update(st, ss, th, lls, jnp.asarray(tr), -3.0, 1.0,
                                 0.1, active=active)
    return st, active, key


def _to_numpy(st):
    out = {f: np.asarray(getattr(st, f)) for f in tsam._FIELDS}
    out["n_steps"] = int(st.n_steps)
    out["mom_ok"] = bool(st.mom_ok)
    return out


@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("tname", ["n=2", "n=3 chain"])
@pytest.mark.parametrize("padded", [True, False])
def test_amis_update_matches_bild_tpu(rng, steps, tname, padded):
    tr = TRANSITIONS[tname]
    k_act = 3
    S, N, K, n = 6, 40, 6 if padded else k_act + 1, tr.shape[0]
    jst, active, key = _jax_state(rng, S, N, K, n, k_act, steps, tr, padded)
    tst = tsam.AmisState.from_numpy(_to_numpy(jst), device="cpu", dtype=F64)
    t_active = None if active is None else T_(np.asarray(active))

    ss, th, jprof = jsam.amis_propose(jst, key, jnp.asarray(tr), N=N, T=20,
                                      active=active)
    _, _, tprof = tsam.amis_propose(tst, None, T_(tr), N=N, T=20,
                                    active=t_active,
                                    draws=(T_(ss), T_(th, torch.int32)))
    np.testing.assert_array_equal(tprof.numpy(), np.asarray(jprof))

    lls = rng.normal(size=N) * 5 - 50
    jst2, jout = jsam.amis_update(jst, ss, th, jnp.asarray(lls), jnp.asarray(tr),
                                  -3.0, 1.0, 0.1, active=active)
    tst2, tout = tsam.amis_update(tst, T_(ss), T_(th, torch.int32), T_(lls),
                                  T_(tr), -3.0, 1.0, 0.1, active=t_active)
    for g, w in zip(tout, jout):
        assert_close(g, w)
    got, want = tst2.to_numpy(), _to_numpy(jst2)
    assert got["n_steps"] == want["n_steps"] == steps + 1
    assert got["mom_ok"] == want["mom_ok"]
    for f in tsam._FIELDS:
        assert_close(got[f], want[f])


def test_log_proposal_infinity_rule():
    """A +inf Dirichlet density dominates a -inf CFC mass (no NaN)."""
    tr = T_(~np.eye(2, dtype=bool))
    a = T_([0.5, 2.0])
    logp = T_([[0.0, math.log(0.5)], [-math.inf, math.log(0.5)]])
    ss = T_([[0.0, 1.0], [0.5, 0.5]])
    th = T_([[1, 0], [0, 1]], torch.int32)
    got = tsam._log_proposal(a, logp, ss, th, tr)
    assert got[0] == math.inf and torch.isfinite(got[1])


@pytest.mark.parametrize("alpha", [0.05, 0.3, 1.0, 2.5, 30.0])
def test_standard_gamma_moments(alpha):
    n = 20000
    x = tdir.standard_gamma(torch.full((n,), alpha, dtype=F64),
                            torch.Generator().manual_seed(11)).numpy()
    assert np.all(x >= 0)
    se = math.sqrt(alpha / n)
    assert abs(x.mean() - alpha) < 4 * se
    assert abs(x.var() - alpha) < 4 * math.sqrt((6 * alpha + 2 * alpha**2) / n)


def test_dirichlet_sample_masked_moments():
    a = torch.tensor([0.4, 2.0, 5.0, 1.0, 1.0], dtype=F64)
    active = torch.tensor([True, True, True, False, False])
    n = 20000
    x = tdir.dirichlet_sample_masked(torch.Generator().manual_seed(5), a,
                                     active, n).numpy()
    assert np.all(x[:, 3:] == 0)
    np.testing.assert_allclose(x.sum(1), 1.0, rtol=1e-12)
    A = 7.4
    m = a[:3].numpy() / A
    se = np.sqrt(m * (1 - m) / (A + 1) / n)
    assert np.all(np.abs(x[:, :3].mean(0) - m) < 4 * se)


@pytest.mark.parametrize("tname", list(TRANSITIONS))
def test_cfc_sample_distribution(rng, tname):
    """Empirical trace frequencies match exp(cfc_logpmf) within 4 SE, and no
    sampled trace takes a forbidden transition."""
    tr = TRANSITIONS[tname]
    n, K, N = tr.shape[0], 3, 30000
    logp = np.log(rng.dirichlet(np.ones(n) * 2, size=K).T)
    th = tcfc.cfc_sample(torch.Generator().manual_seed(9), T_(logp), T_(tr), N)
    assert th.dtype == torch.int32 and th.shape == (N, K)
    th = th.numpy()
    assert np.all(tr[th[:, :-1], th[:, 1:]])
    traces = np.array(list(itertools.product(range(n), repeat=K)))
    traces = traces[np.all(tr[traces[:, :-1], traces[:, 1:]], axis=1)]
    p = np.exp(tcfc.cfc_logpmf(T_(logp), T_(traces), T_(tr)).numpy())
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-12)
    freq = np.array([np.mean(np.all(th == t, axis=1)) for t in traces])
    assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / N) + 1e-12)


def test_cfc_sample_padded_slots_unconstrained():
    tr = T_(np.array([[0, 1], [0, 0]], dtype=bool))   # state 1 is a dead end
    logp = T_(np.log(np.full((2, 4), 0.5)))
    active = T_(np.array([True, True, False, False]))
    th = tcfc.cfc_sample(torch.Generator().manual_seed(1), logp, tr, 500,
                         active=active).numpy()
    assert np.all(th[:, 0] == 0) or np.all(th[:, 1][th[:, 0] == 0] == 1)
    assert set(np.unique(th[:, 2:])) == {0, 1}


def test_solve_marginals_freezes_like_bild_tpu(rng):
    """Checking convergence every few iterations gives exactly the result
    of checking after each one (frozen slots do not move)."""
    tr = TRANSITIONS["n=3"]
    lm = np.log(rng.dirichlet(np.ones(3), size=6).T)
    for precision in (1e-2, 1e-5):
        got, conv = tcfc.cfc_logp_from_marginals(T_(lm), T_(tr),
                                                 precision=precision)
        want, jconv = jcfc.cfc_logp_from_marginals(
            jnp.asarray(lm), jnp.asarray(tr), precision=precision)
        assert_close(got, want)
        assert bool(conv) == bool(jconv)


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("tname", ["n=2", "n=3 chain"])
def test_lane_batched_update_matches_vmapped_bild_tpu(rng, steps, tname):
    """Three lanes at different k (one per-lane mask and prior each), fed
    the same states and draws as bild_tpu's update under jax.vmap."""
    tr = TRANSITIONS[tname]
    S, N, K, n = 5, 32, 5, tr.shape[0]
    k_acts = (1, 3, 2)
    lanes = [_jax_state(rng, S, N, K, n, k, steps, tr, True) for k in k_acts]
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                 *[st for st, _, _ in lanes])
    active = jnp.stack([act for _, act, _ in lanes])
    draws = [jsam.amis_propose(st, key, jnp.asarray(tr), N=N, T=20, active=act)
             for st, act, key in lanes]
    ss, th, jprof = (jnp.stack(x) for x in zip(*draws))
    lls = rng.normal(size=(3, N)) * 5 - 50
    logprior = np.array([-1.0, -3.0, -2.0])

    tst = tsam.AmisState.from_numpy(_to_numpy_lanes(jst), device="cpu",
                                    dtype=F64)
    assert tst.lanes == 3 and tst.n_steps == steps
    t_act = T_(np.asarray(active))
    _, _, tprof = tsam.amis_propose(tst, None, T_(tr), N=N, T=20,
                                    active=t_act,
                                    draws=(T_(ss), T_(th, torch.int32)))
    np.testing.assert_array_equal(tprof.numpy(), np.asarray(jprof))

    jst2, jout = jax.vmap(lambda st, s, t, ll, lp, act: jsam.amis_update(
        st, s, t, ll, jnp.asarray(tr), lp, 1.0, 0.1, active=act))(
        jst, ss, th, jnp.asarray(lls), jnp.asarray(logprior), active)
    tst2, tout = tsam.amis_update(tst, T_(ss), T_(th, torch.int32), T_(lls),
                                  T_(tr), T_(logprior), 1.0, 0.1, active=t_act)
    for g, w in zip(tout, jout):
        assert_close(g, w)
    got, want = tst2.to_numpy(), _to_numpy_lanes(jst2)
    assert got["n_steps"] == steps + 1
    np.testing.assert_array_equal(got["mom_ok"], want["mom_ok"])
    for f in tsam._FIELDS:
        assert_close(got[f], want[f])


def _to_numpy_lanes(st):
    out = {f: np.asarray(getattr(st, f)) for f in tsam._FIELDS}
    steps = np.asarray(st.n_steps)
    assert np.all(steps == steps[0])
    out["n_steps"] = int(steps[0])
    out["mom_ok"] = np.asarray(st.mom_ok)
    return out


@pytest.mark.parametrize("exact", [True, False])
def test_lane_functions_equal_single_lane_calls(rng, exact):
    """Each lane of a lane-batched Dirichlet/CFC density and estimate
    equals the same lane computed alone: bit for bit with lane-exact
    reductions, to round-off with PyTorch's."""
    tr = T_(TRANSITIONS["n=3"])
    L, M, K, n = 4, 60, 5, 3
    a = T_(rng.gamma(2.0, size=(L, K)))
    logp = T_(np.log(rng.dirichlet(np.ones(n), size=(L, K)).transpose(0, 2, 1)))
    ss = T_(rng.dirichlet(np.ones(K), size=(L, M)))
    th = T_(rng.integers(0, n, size=(L, M, K)), torch.int32)
    lw = T_(rng.normal(size=(L, M)))
    active = T_(np.arange(K)[None, :] <= np.array([0, 2, 4, 3])[:, None])

    def run(i=slice(None)):
        return (tdir.dirichlet_logpdf(a[i], ss[i], active[i], exact=exact),
                tcfc.cfc_logpmf(logp[i], th[i], tr, active[i], exact=exact),
                tdir.dirichlet_estimate(ss[i], lw[i], active[i], exact=exact),
                tcfc.cfc_estimate(th[i], lw[i], tr, n, active=active[i],
                                  exact=exact)[0])

    lanes = run()
    for i in range(L):
        for x, y in zip(lanes, run(i)):
            if exact:
                assert torch.equal(x[i], y)
            else:
                assert_close(x[i], y.numpy())


def test_lane_rng_streams_do_not_depend_on_grouping():
    from bild_tpu_torch.lanes import LaneRNG
    rng_all = LaneRNG.from_seeds([11, 12, 13, 14, 15], "cpu").fold(3)
    a = torch.ones((5, 8), dtype=F64)
    active = torch.ones((5, 8), dtype=torch.bool)
    g_all = tdir.dirichlet_sample_masked(rng_all, a, active, 40)
    c_all = tcfc.cfc_sample(rng_all, torch.zeros((5, 3, 8), dtype=F64),
                            T_(TRANSITIONS["n=3"]), 40)
    sub = torch.tensor([3, 1])
    g_sub = tdir.dirichlet_sample_masked(rng_all[sub], a[sub], active[sub], 40)
    c_sub = tcfc.cfc_sample(rng_all[sub], torch.zeros((2, 3, 8), dtype=F64),
                            T_(TRANSITIONS["n=3"]), 40)
    assert torch.equal(g_sub, g_all[sub]) and torch.equal(c_sub, c_all[sub])
    assert not torch.equal(g_all[0], g_all[1])


def test_lane_rng_dirichlet_moments():
    from bild_tpu_torch.lanes import LaneRNG
    a = torch.tensor([[0.4, 2.0, 5.0, 1.0], [3.0, 3.0, 1.0, 1.0]], dtype=F64)
    active = torch.tensor([[True, True, True, False], [True] * 4])
    n = 20000
    x = tdir.dirichlet_sample_masked(LaneRNG.from_seeds([1, 2], "cpu"), a,
                                     active, n).numpy()
    assert np.all(x[0, :, 3] == 0)
    np.testing.assert_allclose(x.sum(-1), 1.0, rtol=1e-12)
    for lane in range(2):
        act = active[lane].numpy()
        A = a[lane].numpy()[act].sum()
        m = a[lane].numpy()[act] / A
        se = np.sqrt(m * (1 - m) / (A + 1) / n)
        assert np.all(np.abs(x[lane][:, act].mean(0) - m) < 4 * se)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_lane_sum_does_not_depend_on_lane_count(dtype):
    from bild_tpu_torch.lanes import lane_cumsum, lane_logsumexp, lane_sum
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(16, 1537)) * 1e3,
                        dtype=dtype)
    _check_lane_reductions(
        x, dtype, *(functools.partial(f, exact=True)
                    for f in (lane_sum, lane_logsumexp, lane_cumsum)))
    # without exact=True they are PyTorch's own
    assert torch.equal(lane_sum(x), x.sum(-1))
    assert torch.equal(lane_cumsum(x), torch.cumsum(x, -1))


def _check_lane_reductions(x, dtype, lane_sum, lane_logsumexp, lane_cumsum):
    full = lane_sum(x)
    assert all(torch.equal(lane_sum(x[i:i + 1])[0], full[i]) for i in range(16))
    np.testing.assert_allclose(full.double().numpy(), x.double().sum(1).numpy(),
                               rtol=1e-5 if dtype == torch.float32 else 1e-12)
    y = x.clone()
    y[3] = -math.inf
    lse = lane_logsumexp(y)
    assert lse[3] == -math.inf
    np.testing.assert_allclose(lse.double().numpy(),
                               torch.logsumexp(y, 1).double().numpy(), rtol=1e-5)
    cs = lane_cumsum(x[:, :40])
    assert all(torch.equal(lane_cumsum(x[i:i + 1, :40])[0], cs[i]) for i in range(16))
    np.testing.assert_allclose(cs.double().numpy(), np.cumsum(x[:, :40].double().numpy(), 1),
                               rtol=1e-4 if dtype == torch.float32 else 1e-12, atol=1e-2)
