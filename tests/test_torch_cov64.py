"""The float32 likelihoods' float64 covariance (`ops.kalman_dense`,
`ops.kalman_sym`): both plain float32 versions, which the CUDA kernels are
held to on the card, against bild_tpu's x64 likelihood at T=1000 with
three states (the construction of chip_smoke.py's ladder rung); the
covariance type taking effect; the float64 versions and the 'torch'
recursion keeping the bits of the recursions they had before the
covariance type existed; the dense plan's float32 covariance at large N."""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bench_e2e_torch import THREE_STATES, truth_profiles
from bild_tpu.ops.kalman import msrouse_logL_batch as j_logL
from bild_tpu_torch.ops import counters, kalman, kalman_dense, kalman_sym
from test_torch_kalman import make_case  # one torch thread per worker
from test_torch_kalman_sym import CASES

# bild_tpu's own bars at T=1000 (BASELINE.md:59-67, its sym exact tier on
# a TPU v5e against float64): relative error per profile, and nats after
# the shift the profiles of one family share
RTOL = 2e-5
CENTERED_NATS = 0.11
TWINS = ("dense", "sym")


def same_bits(a, b):
    """Equal bit for bit, NaN rows included."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


def centered_nats(err, family):
    """Largest |error - mean error| over the profiles of each family."""
    return max(float(np.max(np.abs(err[family == f] - err[family == f].mean())))
               for f in np.unique(family))


@functools.cache
def long_case():
    """One three-state trajectory of T=1000 (N=20, d=3, a loop over frames
    300-600, drawn by the port's float32 model from seed 42) and 131
    profiles in three families (64 every-frame random, 64 segment profiles
    with 0-6 switches, the 3 constant ones; numpy seed 2), as chip_smoke.py's
    ladder draws its T=1000 rung; bild_tpu's x64 likelihood of them on the
    same data. Returns ``(model, traj, prof, family, want)``."""
    T, n = 1000, 3
    kw = dict(d=3, looppositions=THREE_STATES, localization_error=0.1)
    model = bt.models.MultiStateRouse(20, 1.0, 5.0, **kw, device="cpu",
                                      dtype=torch.float32)
    truth = np.zeros(T, dtype=int)
    truth[300:600] = 1
    traj = model.trajectory_from_loopingprofile(
        truth, generator=torch.Generator().manual_seed(42))
    rng = np.random.default_rng(2)
    families = (rng.integers(0, n, size=(64, T)),
                truth_profiles(rng, 64, T, n, k_max=6),
                np.repeat(np.arange(n)[:, None], T, axis=1))
    prof = np.concatenate(families).astype(np.int32)
    family = np.repeat(np.arange(3), [len(f) for f in families])
    jm = bj.models.MultiStateRouse(20, 1.0, 5.0, **kw)
    data = traj.data.double().numpy()
    valid = traj.valid.numpy()
    s2, Cind = jm._noise_arrays(bj.Trajectory.create(np.where(valid[:, None], data,
                                                               np.nan)))
    want = np.asarray(j_logL(jm.Bs, jm.Gs, jm.Sigs, jm.M0s, jm.C0s, jm.w, s2,
                             Cind, jnp.asarray(prof), jnp.asarray(data),
                             jnp.asarray(valid)))
    return model, traj, prof, family, want


def long_twin(name, cov=None):
    """The plain float32 version ``name`` on `long_case` (``cov``: the same
    recursion with that covariance type instead), as float64 numpy."""
    model, traj, prof, *_ = long_case()
    s2, Cind = model._noise_arrays(traj)
    lanes = (torch.as_tensor(prof), traj.data, traj.valid)
    if name == "dense":
        args = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w,
                s2, Cind, *lanes)
        got = (kalman_dense.msrouse_logL_dense_torch(*args) if cov is None else
               kalman.logL_dense_loop(*args, symmetrize=False, cov_dtype=cov))
    else:
        ops = model.sym_operators()
        got = (kalman_sym.msrouse_logL_sym_torch(ops, s2, Cind, *lanes)
               if cov is None else
               kalman_sym._sym_recursion(ops, s2, Cind, *lanes, False, False, cov))
    return got.double().numpy()


@pytest.mark.parametrize("name", TWINS)
def test_float32_twin_meets_bild_tpu_bars_at_T1000(name):
    """Each float32 plain version within rtol 2e-5 per profile and 0.11
    centered nats per family of bild_tpu's x64 likelihood. With a float32
    covariance (the recursions before this repair) the CPU read 0.12
    (dense) and 0.17 (sym) centered nats."""
    *_, family, want = long_case()
    got = long_twin(name)
    assert np.all(np.isfinite(got))
    err = got - want
    assert float(np.max(np.abs(err / want))) <= RTOL
    assert centered_nats(err, family) <= CENTERED_NATS


@pytest.mark.parametrize("name", TWINS)
def test_float32_covariance_drifts_more(name):
    """Not inert: the same recursion with a float32 covariance gives other
    values and drifts more than twice as far from bild_tpu's x64 result."""
    *_, family, want = long_case()
    got, f32 = long_twin(name), long_twin(name, cov=torch.float32)
    assert not np.array_equal(got, f32)
    assert centered_nats(f32 - want, family) > 2 * centered_nats(got - want, family)


@pytest.mark.parametrize("case", list(CASES))
def test_twins_differ_from_float32_covariance(rng, case):
    """At every small case the float32 versions take the float64
    covariance: they differ from the same recursion in float32, while
    their float32 inputs stay float32 and so does the result."""
    _, targs, *_ = make_case(rng, **CASES[case])
    t32 = [x.float() if isinstance(x, torch.Tensor) and x.is_floating_point()
           else x for x in targs]
    dense = kalman_dense.msrouse_logL_dense_torch(*t32)
    ops = kalman_sym.SymOperators.build(*t32[:6], device="cpu",
                                        dtype=torch.float32)
    sym = kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:])
    assert dense.dtype == sym.dtype == torch.float32
    assert not same_bits(dense, kalman.logL_dense_loop(
        *t32, symmetrize=False, cov_dtype=torch.float32))
    assert not same_bits(sym, kalman_sym._sym_recursion(
        ops, *t32[6:], False, False, torch.float32))
    assert same_bits(dense, kalman.logL_dense_loop(
        *t32, symmetrize=False, cov_dtype=torch.float64))


def parent_dense(Bs, Gs, Sigs, M0s, C0s, w, s2, Cind, profiles, ydata, valid,
                 symmetrize):
    """The dense recursion as it stood before the covariance type
    (`ops.kalman.logL_dense_loop` and `kalman_update_batch`, single-lane
    form), kept here verbatim to hold the unchanged paths' bits."""
    P, T = profiles.shape
    n, q = Bs.shape[0], s2.shape[0]
    Cind = torch.as_tensor(Cind, dtype=torch.long)
    prof = profiles.long().clamp(0, n - 1)
    lane = torch.zeros(P, dtype=torch.long)
    ydata, valid = ydata[None], valid[None]
    M = M0s[prof[:, 0]]
    C = C0s[prof[:, 0]][:, None].expand(P, q, *C0s.shape[1:])
    acc = torch.zeros((P,), dtype=ydata.dtype)

    def observe(t, M, C, acc):
        Cw = torch.einsum("pqij,j->pqi", C, w)
        S = torch.einsum("pqi,i->pq", Cw, w) + s2
        K = Cw / S[..., None]
        C_u = C - K[..., :, None] * Cw[..., None, :]
        xmm = ydata[lane, t] - torch.einsum("pid,i->pd", M, w)
        M_u = M + K[:, Cind].transpose(1, 2) * xmm[:, None, :]
        Sd = S[:, Cind]
        logl = -0.5 * (xmm * xmm / Sd + torch.log(Sd) + kalman.LOG_2PI)
        v = valid[lane, t]
        return (torch.where(v[:, None, None], M_u, M),
                torch.where(v[:, None, None, None], C_u, C),
                acc + torch.where(v, logl.sum(dim=1), 0.0))

    M, C, acc = observe(0, M, C, acc)
    for t in range(1, T):
        B = Bs[prof[:, t]]
        M = torch.bmm(B, M) + Gs[prof[:, t]]
        X = torch.einsum("pij,pqjk->pqik", B, C)
        C = torch.einsum("pqik,pkj->pqij", X, B) + Sigs[prof[:, t]][:, None]
        if symmetrize:
            C = 0.5 * (C + C.transpose(-1, -2))
        M, C, acc = observe(t, M, C, acc)
    return torch.where(kalman.in_range_mask(profiles, n), acc,
                       torch.full_like(acc, math.nan))


def parent_sym(ops, s2, Cind, profiles, ydata, valid):
    """The packed recursion's exact tier as it stood before the covariance
    type (`ops.kalman_sym.msrouse_logL_sym_torch`, single-lane form),
    kept here verbatim."""
    P, T = profiles.shape
    n, N, PPp, q = ops.n, ops.N, ops.PPp, s2.shape[0]
    Cind = torch.as_tensor(Cind, dtype=torch.long)
    prof = profiles.long().clamp(0, n - 1)
    lane = torch.zeros(P, dtype=torch.long)
    ydata, valid = ydata[None], valid[None]
    ia, ja = (torch.as_tensor(i) for i in np.triu_indices(N))
    c = ops.c0[prof[:, 0]][:, None, :].expand(P, q, PPp)
    M = ops.M0w[prof[:, 0]]
    acc = torch.zeros((P,), dtype=ydata.dtype)

    def observe(t, c, M, acc):
        R1 = c @ ops.U1.T
        Cw, Sinv = R1[..., :N], 1.0 / (R1[..., ops.S_OFF] + s2)
        upd = torch.zeros_like(c)
        upd[..., :len(ia)] = Cw[..., ia] * Cw[..., ja]
        c_u = c - upd * Sinv[..., None]
        xmm = ydata[lane, t] - M[:, N, :]
        K = Cw * Sinv[..., None]
        M_top = M[:, :N] + K[:, Cind].transpose(1, 2) * xmm[:, None, :]
        M_u = torch.cat([M_top, M[:, N:]], dim=1)
        Sd = Sinv[:, Cind]
        ll = (-0.5 * (xmm * xmm * Sd - torch.log(Sd) + kalman.LOG_2PI)).sum(dim=1)
        v = valid[lane, t]
        return (torch.where(v[:, None, None], c_u, c),
                torch.where(v[:, None, None], M_u, M),
                acc + torch.where(v, ll, 0.0))

    c, M, acc = observe(0, c, M, acc)
    rows = torch.arange(P)
    for t in range(1, T):
        st = prof[:, t]
        c = (c @ ops.Pall.T).view(P, q, n, PPp)[rows, :, st] + ops.sig[st][:, None, :]
        BM = torch.einsum("rk,pkd->prd", ops.Ballw, M[:, :N])
        M = BM.view(P, n, ops.N1p, -1)[rows, st] + ops.Gsw[st]
        c, M, acc = observe(t, c, M, acc)
    return torch.where(kalman.in_range_mask(profiles, n), acc,
                       torch.full_like(acc, math.nan))


@pytest.mark.parametrize("case", list(CASES))
def test_unchanged_paths_keep_their_bits(rng, case):
    """Bit for bit against the recursions as they stood before the
    covariance type: both float64 plain versions, and the 'torch'
    recursion (`msrouse_logL_batch`, the CPU models' path) in float64 and
    float32, whose covariance stays in the inputs' type."""
    _, t64, *_ = make_case(rng, **CASES[case])
    ops = kalman_sym.SymOperators.build(*t64[:6], device="cpu",
                                        dtype=torch.float64)
    assert same_bits(kalman_dense.msrouse_logL_dense_torch(*t64),
                     parent_dense(*t64, symmetrize=False))
    assert same_bits(kalman_sym.msrouse_logL_sym_torch(ops, *t64[6:]),
                     parent_sym(ops, *t64[6:]))
    t32 = [x.float() if isinstance(x, torch.Tensor) and x.is_floating_point()
           else x for x in t64]
    for args in (t64, t32):
        assert same_bits(kalman.msrouse_logL_batch(*args),
                         parent_dense(*args, symmetrize=True))


def test_dense_plan_keeps_float32_covariance_only_at_large_N(rng):
    """At N=119, q=3 (d=3, n=2) float32 still plans, with a float32
    covariance (the large-N plan), and the plain version follows it; at
    every launch of the README model, configs 3-5 and the bench shape
    (N=20) the covariance is float64. Such launches have their counter."""
    big = kalman_dense.dense_plan(1, 100, 2, 119, 3, 3, 4)
    assert big.cov_itemsize == 4 and big.smem <= kalman_dense.SMEM_LIMIT
    assert kalman_dense.dense_cov_itemsize(2, 119, 3, 3, 4) == 4
    assert kalman_dense.dense_plan(1, 100, 2, 84, 3, 3, 8).cov_itemsize == 8
    for L, P, n in ((1, 100, 2), (1, 8192, 2), (640, 128, 2), (320, 128, 2),
                    (64, 9, 2), (112, 128, 3), (48, 128, 3), (5120, 128, 2)):
        for q in (1, 3):
            assert kalman_dense.dense_plan(L, P, n, 20, 3, q, 4).cov_itemsize == 8
    # the first N of the large-N plan, as the module docstring states
    starts = {q: min(N for N in range(1, 200)
                     if kalman_dense.dense_cov_itemsize(2, N, 3, q, 4) == 4)
              for q in (1, 3)}
    assert starts == {1: 121, 3: 85}
    assert counters.COUNTERS["kalman_dense_cov32"] == (
        kalman_dense.msrouse_logL_dense, "cov32_launches")
    _, targs, *_ = make_case(rng, N=119, T=3, P=2, locerr=(0.1, 0.2, 0.3))
    t32 = [x.float() if isinstance(x, torch.Tensor) and x.is_floating_point()
           else x for x in targs]
    assert same_bits(kalman_dense.msrouse_logL_dense_torch(*t32),
                     kalman.logL_dense_loop(*t32, symmetrize=False,
                                            cov_dtype=torch.float32))
