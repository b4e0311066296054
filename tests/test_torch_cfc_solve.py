"""The CFC fixed-point solve (bild_tpu_torch.amis.cfc): the plain batched
loop `_solve_marginals` against bild_tpu's `lax.while_loop` (float64), a
loop over one slot at a time written as csrc/cfc_solve.cu computes it
(each slot stopping on its own) against the batched loop bit for bit, the
dispatch of `solve_marginals` (the CPU runs the plain loop), the kernel's
grid planner `solve_plan`, and on the card the kernel against the plain
loop at every state count with a kernel of its own (marked `cuda`)."""
import math

import numpy as np
import pytest
import torch

from bild_tpu_torch.amis import cfc as tcfc

torch.set_num_threads(1)

F64 = torch.float64
TRANSITIONS = {
    "n=2": ~np.eye(2, dtype=bool),
    "n=3": ~np.eye(3, dtype=bool),
    "n=3 chain": np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]], dtype=bool),
    "n=4 sparse": np.array([[1, 1, 0, 0], [0, 1, 1, 0], [0, 0, 1, 1],
                            [1, 0, 0, 1]], dtype=bool),
}


def marginals(rng, M, n):
    """``(M, n)`` log-marginals: random ones, with zero entries (-inf) and
    Kronecker deltas (a 0) in some rows."""
    p = rng.dirichlet(np.ones(n), size=M)
    p[rng.random((M, n)) < 0.15] = 0
    p[p.sum(1) == 0, 0] = 1
    p /= p.sum(1, keepdims=True)
    delta = rng.random(M) < 0.1
    p[delta] = 0
    p[delta, rng.integers(0, n, int(delta.sum()))] = 1
    with np.errstate(divide="ignore"):
        return np.log(p)


def case(rng, M, n):
    logf, logg = marginals(rng, M, n), marginals(rng, M, n)
    frozen = rng.random(M) < 0.1
    return logf, logg, frozen


@pytest.mark.parametrize("tname", list(TRANSITIONS))
@pytest.mark.parametrize("precision,maxiter", [(1e-2, 1000), (1e-7, 60)])
def test_plain_solve_matches_bild_tpu(rng, tname, precision, maxiter):
    import jax.numpy as jnp      # here: the card's tests run without JAX
    from bild_tpu.amis import cfc as jcfc

    tr = TRANSITIONS[tname]
    logf, logg, frozen = case(rng, 40, tr.shape[0])
    got, conv = tcfc._solve_marginals(
        torch.as_tensor(logf), torch.as_tensor(logg), torch.as_tensor(tr),
        maxiter, precision, frozen=torch.as_tensor(frozen), exact=True)
    want, jconv = jcfc._solve_marginals(
        jnp.asarray(logf), jnp.asarray(logg), jnp.asarray(tr), maxiter,
        precision, frozen=jnp.asarray(frozen))
    want = np.asarray(want)
    got = got.numpy()
    assert np.array_equal(conv.numpy(), np.asarray(jconv))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)],
                          equal_nan=True)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-14)
    assert not conv.all() or precision > 1e-3      # both kinds of rows


def exact_lse(x):
    """lanes.lane_logsumexp(exact=True) of a vector, step by step as the
    kernel takes it: the max (NaN if any entry is), 0 if not finite, exp
    of the differences zero-padded to a power of two, the pairwise tree,
    log plus the max."""
    n = x.shape[0]
    m = x.amax().nan_to_num(nan=0.0, posinf=0.0, neginf=0.0)
    s = torch.exp(x - m)
    size = 1 << (n - 1).bit_length()
    s = torch.cat([s, s.new_zeros(size - n)])
    while size > 1:
        size //= 2
        s = s[:size] + s[size:2 * size]
    return torch.log(s[0]) + m


def solve_one_slot(logf, logg, tr, frozen, maxiter, precision):
    """One slot's solve with its own loop, as csrc/cfc_solve.cu runs it in
    one thread: ``(logp (n,), converged)``."""
    n = logf.shape[0]
    ninf = torch.tensor(-math.inf, dtype=logf.dtype)
    zero = torch.zeros((), dtype=logf.dtype)
    is_delta = bool((logf == 0).any() | (logg == 0).any())
    done = is_delta or frozen
    p = logf.clone()
    it = 0
    while it < maxiter and not done:
        norm = torch.stack([
            zero if logg[i] == -math.inf
            else exact_lse(torch.where(tr[i], p, ninf)) for i in range(n)])
        q = torch.stack([
            logf[j] - (zero if logf[j] == -math.inf
                       else exact_lse(torch.where(tr[:, j], logg - norm, ninf)))
            for j in range(n)])
        q = q - exact_lse(q)
        delta = torch.where(logf == -math.inf, zero, (q - p).abs())
        done = bool(delta.amax() < precision)
        p = q
        it += 1
    return (logf if is_delta else p), done


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("tname", ["n=2", "n=3 chain", "n=4 sparse"])
def test_one_slot_at_a_time_equals_the_batched_loop(rng, dtype, tname):
    """bild_tpu's claim (cfc.py:131-134) held for the port: a slot freezes
    at its first converged iterate, so solving each slot alone gives the
    batched loop's bits."""
    tr = torch.as_tensor(TRANSITIONS[tname])
    M, maxiter, precision = 24, 40, 1e-4
    logf, logg, frozen = case(rng, M, tr.shape[0])
    logf = torch.as_tensor(logf, dtype=dtype)
    logg = torch.as_tensor(logg, dtype=dtype)
    want, wconv = tcfc._solve_marginals(logf, logg, tr, maxiter, precision,
                                        frozen=torch.as_tensor(frozen),
                                        exact=True)
    for r in range(M):
        got, conv = solve_one_slot(logf[r], logg[r], tr, bool(frozen[r]),
                                   maxiter, precision)
        assert conv == bool(wconv[r]), r
        assert torch.equal(got.nan_to_num(), want[r].nan_to_num()), r
    assert 0 < int(wconv.sum()) < M


def test_solve_marginals_runs_the_plain_loop_on_the_cpu(rng):
    tr = TRANSITIONS["n=3"]
    logf, logg, frozen = case(rng, 12, 3)
    args = (torch.as_tensor(logf).reshape(3, 4, 3),
            torch.as_tensor(logg).reshape(3, 4, 3), torch.as_tensor(tr), 100,
            1e-3)
    calls, launches = tcfc._solve_marginals.calls, tcfc.solve_marginals.launches
    got = tcfc.solve_marginals(*args, frozen=torch.as_tensor(frozen[:4]),
                               exact=True)
    want = tcfc._solve_marginals(*args, frozen=torch.as_tensor(frozen[:4]),
                                 exact=True)
    assert tcfc._solve_marginals.calls == calls + 2
    assert tcfc.solve_marginals.launches == launches
    assert all(torch.equal(a.nan_to_num(), b.nan_to_num())
               for a, b in zip(got, want))
    lm = np.log(rng.dirichlet(np.ones(3), size=5).T)
    calls = tcfc._solve_marginals.calls
    tcfc.cfc_logp_from_marginals(torch.as_tensor(lm), torch.as_tensor(tr))
    assert tcfc._solve_marginals.calls == calls + 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def test_solve_plan_at_every_state_count():
    """`solve_plan`: up to `SOLVE_GROUP_STATES` states a group of threads
    per row, the power of two >= n, so that a warp holds whole rows; above,
    a thread per row; blocks of `SOLVE_THREADS` covering every row's
    threads, the last block not empty."""
    assert tcfc.SOLVE_GROUP_STATES == 8
    for n in range(1, tcfc.SOLVE_MAX_STATES + 1):
        for M in (1, 7, 20, 33, 1961, 2560):
            group, threads, blocks = tcfc.solve_plan(M, n)
            if n <= tcfc.SOLVE_GROUP_STATES:
                assert group >= n > group // 2 and group & (group - 1) == 0
                assert 32 % group == 0 and threads % group == 0
            else:
                assert group == 1
            assert threads == tcfc.SOLVE_THREADS and threads % 32 == 0
            assert blocks * threads >= M * group > (blocks - 1) * threads
    assert tcfc.solve_plan(2560, 2) == (2, 64, 80)      # config 3's scout
    assert tcfc.solve_plan(672, 3) == (4, 64, 42)       # config 4's scout
    assert tcfc.solve_plan(20, 2) == (2, 64, 1)         # sample()'s step


def transitions(rng, n):
    """A random ``(n, n)`` transition matrix in which every state may move
    on to the next (so no row is empty)."""
    tr = rng.random((n, n)) < 0.6
    tr[np.arange(n), (np.arange(n) + 1) % n] = True
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("rows", [(40, 50), (37, 53)])
def test_cuda_kernel_matches_plain(cuda, dtype, rows):
    """The kernel against the plain loop on the card: float64 within 1e-12
    relative, float32 within 4 ulp, the same converged flags, NaN and
    infinities where the plain loop has them; cut to one iteration, the
    plain loop's converged flags at that cut. `TRANSITIONS`, then a random
    matrix at each state count with a kernel of its own (1 to 8) and at 9,
    33 and 64 (the general path), on 2,000 rows and on 1,961 (a count that
    is not a multiple of a warp's rows at any group size)."""
    rng = np.random.default_rng(7)
    cases = list(TRANSITIONS.items())
    cases += [(f"n={n} random", transitions(rng, n))
              for n in (*range(1, tcfc.SOLVE_GROUP_STATES + 1), 9, 33, 64)]
    for tname, tr in cases:
        logf, logg, frozen = case(rng, math.prod(rows), tr.shape[0])
        args = [torch.as_tensor(x, dtype=dtype, device=cuda).reshape(*rows, -1)
                for x in (logf, logg)]
        tr_c = torch.as_tensor(tr, device=cuda)
        fz = torch.as_tensor(frozen, device=cuda).reshape(rows)
        launches = tcfc.solve_marginals.launches
        got, conv = tcfc.solve_marginals(*args, tr_c, 1000, 1e-2, frozen=fz)
        assert tcfc.solve_marginals.launches == launches + 1
        want, wconv = tcfc._solve_marginals(*args, tr_c, 1000, 1e-2,
                                            frozen=fz, exact=True)
        got, want = got.cpu().double().numpy(), want.cpu().double().numpy()
        assert torch.equal(conv.cpu(), wconv.cpu()), tname
        assert np.array_equal(np.isfinite(got), np.isfinite(want)), tname
        assert np.array_equal(got[~np.isfinite(want)], want[~np.isfinite(want)],
                              equal_nan=True), tname
        fin = np.isfinite(want)
        if dtype == F64:
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12,
                                       err_msg=tname)
        else:
            ulp = np.spacing(np.abs(want[fin]).astype(np.float32))
            assert np.max(np.abs(got[fin] - want[fin]) / ulp, initial=0) <= 4, tname
        _, cut = tcfc.solve_marginals(*args, tr_c, 1, 1e-2, frozen=fz)
        _, wcut = tcfc._solve_marginals(*args, tr_c, 1, 1e-2, frozen=fz,
                                        exact=True)
        assert torch.equal(cut.cpu(), wcut.cpu()), tname
