"""The packed kernel's matmul tiers (`bild_tpu_torch.config.rouse_matmul`,
'auto'/'exact'/'split'/'split_cov'): the configuration against
bild_tpu's, the plain split tiers against bild_tpu's Pallas kernel in
interpret mode (float32), the operators' bfloat16 pairs and the kernel's
fragment order, the models' dispatch, and (on a GPU) the CUDA kernel
against the plain version."""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu import Trajectory
from bild_tpu import config as jconfig
from bild_tpu.ops.kalman import msrouse_logL_batch as j_logL
from bild_tpu.models import MultiStateRouse
from bild_tpu.ops.kalman_sym import msrouse_logL_pallas_sym, sym_operators
from bild_tpu_torch import config
from bild_tpu_torch.ops import kalman_sym
from test_torch_kalman import make_case, make_lane_case
from test_torch_kalman_sym import CASES

SPLIT = ("split", "split_cov")
# The plain tiers against bild_tpu's interpret-mode kernel, both float32.
# 'split_cov' agrees at the exact tiers' float32 noise (at most 5.5e-7 on
# CASES). 'split' cannot: it rounds each covariance slot to its bf16 pair
# (16 of 24 bits) before the update contraction, so a one-ulp difference
# in a slot can move its low half by one bf16 ulp (2^-17 of the slot), 64
# times the ulp, and the measurement variance S = w.C.w takes such a slot
# with the cancellation of the end-to-end distance. Two float32
# implementations that sum the conjugation in another order then differ
# at the size of the tier's own error: the port's plain version with its
# split products rounded from float64 moves 'split' by up to 9.8e-6 on
# CASES and 'split_cov' by 3.4e-7
# (test_split_tier_sensitive_to_summation_order). On CASES the port is at
# most 9.3e-6 from bild_tpu; the bar is 5e-5, the size of the tier's own
# error against the oracle (up to 5.3e-5 there), because how far two
# summation orders land apart depends on the draw as erratically as the
# rounding above. At that bar a 'split' without its update split would
# pass too; the two-frame tests (RTOL_SHORT) tell the tiers apart.
RTOL_TPU = {"split_cov": 1e-5, "split": 5e-5}
# both tiers against the x64 oracle: bild_tpu's own bar
# (tests/test_kalman_sym.py::test_rouse_matmul_split_f32_numerics)
RTOL_ORACLE = 2e-4
# Each split tier at the shortest length where its split acts on inputs
# that both implementations hold bit for bit (SHORT_T): 'split' at one
# frame (the update contraction of the host's c0), 'split_cov' at two
# (the conjugation of the first update's output, which feeds an exact
# update). There the plain tiers agree with bild_tpu's to float32 noise
# (at most 1.9e-7 on SHORT, relative to max(|logL|, 1 nat)) and lie at
# least 3.7e-6 from what a skipped split computes ('split': the exact
# tier, which 'split_cov' is at one frame; 'split_cov': 'split'), so
# RTOL_SHORT tells the tiers apart; each tier's shift from the exact tier
# is bild_tpu's (least-squares slope within SLOPE; a kernel without the
# split has none). 'split' is not held at two frames: its update
# contraction rounds the conjugation's output to bf16 pairs, and one bf16
# ulp in the low half of one slot moves it by more than its whole shift
# from the exact tier (test_split_update_amplifies_one_bf16_ulp), so a
# conjugation that rounds otherwise, as the tensor cores' accumulation
# does, moves it past the bar in some draws. chip_smoke.py's split phase
# holds the CUDA kernel to the same bars.
RTOL_SHORT = 1e-6
SLOPE = (0.5, 2.0)
SHORT_T = {"split": 1, "split_cov": 2}
SHORT = {
    "N=20": dict(N=20, locerr=0.1),
    "N=20 q=3": dict(N=20, locerr=(0.1, 0.2, 0.1)),
    "N=12 NaN rows": dict(N=12, locerr=0.3, bad=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture
def restore_matmul():
    """Both packages' configured tier, restored after the test."""
    before = (config.rouse_matmul(), jconfig.rouse_matmul())
    try:
        yield
    finally:
        config.set_rouse_matmul(before[0])
        jconfig.set_rouse_matmul(before[1])


def f32_case(rng, **case):
    """A case of `make_case` in float32 for both packages, and its x64
    oracle (bild_tpu's XLA recursion)."""
    jargs, targs, *_ = make_case(rng, **case)
    j32 = [jnp.asarray(a, jnp.float32) if np.asarray(a).dtype == np.float64
           else a for a in jargs]
    t32 = [x.float() if isinstance(x, torch.Tensor) and x.is_floating_point()
           else x for x in targs]
    return j32, t32, np.asarray(j_logL(*jargs))


def rel(got, want, floor=0.0):
    """Largest relative error over the finite rows, each relative to
    max(|want|, floor)."""
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    return float(np.max(np.abs(got[fin] - want[fin])
                        / np.maximum(np.abs(want[fin]), floor)))


def shift_slope(got, want):
    """The least-squares slope of shift ``got`` on shift ``want``."""
    fin = np.isfinite(want)
    return float(got[fin] @ want[fin] / (want[fin] @ want[fin]))


def short_lanes(rng, T, N=20, locerr=0.1, bad=False, L=16, P=8):
    """A lane batch of ``T`` frames in float32 for both packages: L
    trajectories of random data (lane 1 misses frame 1 where there is
    one), random two-state profiles, out-of-range rows where ``bad``.
    Returns (bild_tpu model args, port model args, profiles, data,
    mask)."""
    model = MultiStateRouse(N, 1.0, 4.0, d=3, localization_error=locerr)
    ydata = rng.normal(size=(L, T, 3)).astype(np.float32)
    valid = np.ones((L, T), dtype=bool)
    valid[1, T - 1:] = T < 2
    ydata[~valid] = np.nan
    prof = rng.integers(0, 2, size=(L, P, T)).astype(np.int32)
    if bad:
        prof[2, 3, T - 1], prof[5, 0, 0] = 2, -1
    s2, Cind = model._noise_arrays(Trajectory.create(ydata[0]))
    host = (model.Bs, model.Gs, model.Sigs, model.M0s, model.C0s, model.w, s2)
    jm = [jnp.asarray(a, jnp.float32) for a in host] + [Cind]
    tm = [torch.as_tensor(np.array(a), dtype=torch.float32) for a in host]
    return jm, tm + [np.asarray(Cind)], prof, ydata, valid


def short_tiers(rng, case, T):
    """Every tier of one `SHORT` case at ``T`` frames: the port's plain
    version and bild_tpu's interpret kernel (one call per lane), float32,
    as float64 arrays."""
    jm, tm, prof, ydata, valid = short_lanes(rng, T, **SHORT[case])
    ops = kalman_sym.SymOperators.build(*tm[:6], device="cpu",
                                        dtype=torch.float32)
    lanes = (torch.as_tensor(prof), torch.as_tensor(ydata), torch.as_tensor(valid))
    plain = {t: kalman_sym.msrouse_logL_sym_torch(ops, *tm[6:], *lanes, matmul=t)
             .double().numpy() for t in kalman_sym.TIERS}
    jtpu = {t: np.stack([np.asarray(msrouse_logL_pallas_sym(
                *jm, jnp.asarray(prof[i]), jnp.asarray(ydata[i]),
                jnp.asarray(valid[i]), interpret=True, matmul=t))
                         for i in range(len(prof))]).astype(float)
            for t in kalman_sym.TIERS}
    return plain, jtpu


@pytest.mark.parametrize("mode", config.MATMUL_MODES)
def test_resolve_matmul_matches_bild_tpu(restore_matmul, mode):
    config.set_rouse_matmul(mode)
    jconfig.set_rouse_matmul(mode)
    assert config.rouse_matmul() == jconfig.rouse_matmul() == mode
    assert config.SPLIT_MAX_T == jconfig.SPLIT_MAX_T == 128
    for context, T in itertools.product(("lockstep", "single"),
                                        (None, 100, 128, 129, 1000)):
        assert (config.resolve_matmul(context, T=T)
                == jconfig.resolve_matmul(context, T=T)), (context, T)
    assert config.resolve_matmul() == jconfig.resolve_matmul()


def test_bad_names_raise_in_both(restore_matmul):
    before = config.rouse_matmul()
    for pkg in (config, jconfig):
        with pytest.raises(ValueError, match="rouse_matmul"):
            pkg.set_rouse_matmul("bf16")
        with pytest.raises(ValueError, match="context"):
            pkg.resolve_matmul("dataset")
    assert config.rouse_matmul() == before       # unchanged by the refusal
    with pytest.raises(ValueError, match="matmul must be"):
        kalman_sym.check_tier("auto")            # a mode, not a tier


@pytest.mark.parametrize("tier", SPLIT)
@pytest.mark.parametrize("case", list(CASES))
def test_plain_split_matches_pallas_interpret(rng, case, tier):
    j32, t32, oracle = f32_case(rng, **CASES[case])
    want = np.asarray(msrouse_logL_pallas_sym(*j32, interpret=True,
                                              matmul=tier))
    ops = kalman_sym.SymOperators.build(*t32[:6], device="cpu",
                                        dtype=torch.float32)
    got = kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:], matmul=tier).numpy()
    assert rel(got, want) <= RTOL_TPU[tier]
    assert rel(got, oracle) <= RTOL_ORACLE


@pytest.mark.parametrize("tier", SPLIT)
@pytest.mark.parametrize("case", list(SHORT))
def test_short_split_tiers_match_bild_tpu(rng, case, tier):
    """At its `SHORT_T` frames each plain split tier is within RTOL_SHORT
    of bild_tpu's, and at least twice that far from the tier a kernel
    that skipped its split would compute ('split': the exact tier;
    'split_cov': 'split')."""
    plain, jtpu = short_tiers(rng, case, SHORT_T[tier])
    assert rel(plain[tier], jtpu[tier], floor=1.0) <= RTOL_SHORT
    near = "exact" if tier == "split" else "split"
    assert rel(plain[tier], plain[near], floor=1.0) >= 2 * RTOL_SHORT


@pytest.mark.parametrize("tier", SPLIT)
@pytest.mark.parametrize("case", list(SHORT))
def test_short_split_tiers_shift_as_bild_tpu(rng, case, tier):
    """At its `SHORT_T` frames each tier's shift from the exact tier is
    bild_tpu's: the least-squares slope of one on the other within SLOPE."""
    plain, jtpu = short_tiers(rng, case, SHORT_T[tier])
    slope = shift_slope(jtpu[tier] - jtpu["exact"], plain[tier] - plain["exact"])
    assert SLOPE[0] <= slope <= SLOPE[1]


@pytest.mark.parametrize("case", list(SHORT))
def test_split_update_amplifies_one_bf16_ulp(rng, monkeypatch, case):
    """Why 'split' is held at one frame: at two frames, one bf16 ulp more
    in the low half of slot (0, 0) of the conjugation's output, as the
    update contraction splits it, moves 'split' by more than half its
    whole shift from the exact tier, and by more than twice RTOL_SHORT
    (S = w.C.w cancels)."""
    _, tm, prof, ydata, valid = short_lanes(rng, 2, **SHORT[case])
    ops = kalman_sym.SymOperators.build(*tm[:6], device="cpu",
                                        dtype=torch.float32)
    lanes = (torch.as_tensor(prof), torch.as_tensor(ydata), torch.as_tensor(valid))

    def run(tier):
        return kalman_sym.msrouse_logL_sym_torch(
            ops, *tm[6:], *lanes, matmul=tier).double().numpy()

    plain = {t: run(t) for t in ("exact", "split")}
    split_product, calls = kalman_sym.split_product, []

    def one_ulp(product, pair, x):
        if pair is not ops.pairs["U1"]:
            return split_product(product, pair, x)
        calls.append(None)
        x_hi, x_lo = kalman_sym.hi_lo(x)
        if len(calls) == 2:                        # frame 1's contraction
            x_lo = x_lo.clone()
            x_lo[..., 0] = torch.nextafter(x_lo[..., 0],
                                           torch.full_like(x_lo[..., 0], math.inf))
        a_hi, a_lo = (v.float() for v in pair)
        x_hi, x_lo = x_hi.float(), x_lo.float()
        return product(a_hi, x_hi) + product(a_hi, x_lo) + product(a_lo, x_hi)

    monkeypatch.setattr(kalman_sym, "split_product", one_ulp)
    moved = rel(run("split"), plain["split"], floor=1.0)
    assert len(calls) == 2
    assert moved >= 2 * RTOL_SHORT
    assert moved >= rel(plain["split"], plain["exact"], floor=1.0) / 2


def test_split_tiers_are_not_inert_and_float64_is_exact(rng):
    """In float32 the three tiers differ from each other; in float64 both
    split tiers give the exact tier's bits (bild_tpu skips the split
    below float32), through the plain version and the wrapper."""
    _, t32, _ = f32_case(rng, **CASES["q=3 missing frames"])
    ops = kalman_sym.SymOperators.build(*t32[:6], device="cpu",
                                        dtype=torch.float32)
    got = {t: kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:], matmul=t)
           for t in kalman_sym.TIERS}
    for a, b in itertools.combinations(kalman_sym.TIERS, 2):
        assert not torch.equal(got[a], got[b]), (a, b)
    _, t64, *_ = make_case(rng, **CASES["q=3 missing frames"])
    ops64 = kalman_sym.SymOperators.build(*t64[:6], device="cpu",
                                          dtype=torch.float64)
    exact = kalman_sym.msrouse_logL_sym_torch(ops64, *t64[6:])
    for tier in SPLIT:
        assert torch.equal(kalman_sym.msrouse_logL_sym_torch(
            ops64, *t64[6:], matmul=tier), exact)
        assert torch.equal(kalman_sym.msrouse_logL_sym(
            *t64, ops=ops64, matmul=tier), exact)


@pytest.mark.parametrize("N,n", [(9, 2), (6, 3)])
def test_operator_pairs_equal_bild_tpu_hi_lo(rng, N, n):
    """The plain version's (hi, lo) pairs are bild_tpu's kernel split
    (``hi_lo`` of ``Pall_ref[:]``, ``U1_ref[:]``, ``Ballw_ref[:]``) of its
    float32 operators, bit for bit."""
    Bs, Sigs, C0s = (rng.normal(size=(n, N, N)) for _ in range(3))
    Gs, M0s = rng.normal(size=(n, N, 3)), rng.normal(size=(n, N, 3))
    w = rng.normal(size=N)
    (Pall, _, _, U1, Ballw, *_), *_ = sym_operators(Bs, Gs, Sigs, M0s, C0s,
                                                    w, jnp.float32)

    def j_hi_lo(a):
        hi = a.astype(jnp.bfloat16)
        lo = (a - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        return [np.asarray(x).view(np.int16) for x in (hi, lo)]

    ops = kalman_sym.SymOperators.build(Bs, Gs, Sigs, M0s, C0s, w,
                                        device="cpu", dtype=torch.float32)
    for name, arr in (("Pall", Pall), ("U1", U1), ("Ballw", Ballw)):
        for got, want in zip(ops.pairs[name], j_hi_lo(arr)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("N,n", [(20, 2), (6, 3), (1, 2)])
def test_split_fragments_hold_the_pairs(rng, N, n):
    """The split kernel's operator stream (``split_stages``), read back at
    the offsets its producer copies from (state s, m-block mb of 64 rows,
    stage kc of _DEPTH columns at byte (s KP^2 + 64 mb KP + rows _DEPTH
    kc) 4, the hi tile then the lo tile, core matrix (rg, kg) at 128 (rg
    _DEPTH / 8 + kg)), holds every operator entry's hi and lo bit for bit
    and zeros in the padding to whole stages."""
    Bs = rng.normal(size=(n, N, N))
    Pall, *_, PPp, _ = kalman_sym.build_sym_operators(
        Bs, rng.normal(size=(n, N, 1)), Bs, rng.normal(size=(n, N, 1)), Bs,
        rng.normal(size=N))
    stream = kalman_sym.split_stages(Pall, n, PPp)
    D = kalman_sym._DEPTH
    KP = -(-PPp // D) * D
    assert stream.shape == (n, 2 * KP * KP) and stream.dtype == np.int16
    raw = stream.view(np.uint8)
    back = np.zeros((2, n, KP, KP), dtype=np.int16)
    for s, mb, kc, half in itertools.product(range(n), range(-(-KP // 64)),
                                             range(KP // D), range(2)):
        rows = min(64, KP - 64 * mb)
        at = (64 * mb * KP + rows * D * kc) * 4 + half * rows * D * 2
        tile = raw[s, at:at + rows * D * 2].view(np.int16)
        back[half, s, 64 * mb:64 * mb + rows, D * kc:D * (kc + 1)] = (
            tile.reshape(rows // 8, D // 8, 8, 8).transpose(0, 2, 1, 3)
            .reshape(rows, D))
    pairs = kalman_sym.hi_lo(torch.as_tensor(Pall.reshape(n, PPp, PPp),
                                             dtype=torch.float32))
    for half, pair in zip(back, pairs):
        np.testing.assert_array_equal(half[:, :PPp, :PPp],
                                      pair.view(torch.int16).numpy())
        assert not half[:, PPp:].any() and not half[:, :, PPp:].any()


# chip_smoke.py's bar for the split kernel's probe (PROBE_RTOL): frame 1's
# Cw, 1/S and propagated means against the plain steps on the kernel's own
# inputs, relative to each quantity's largest entry
PROBE_RTOL = 4e-7


@pytest.mark.parametrize("case", list(SHORT))
def test_split_probe_bar_tells_the_splits_apart(rng, case):
    """The plain update contraction and mean propagation of 'split'
    (``update_contraction``, ``mean_propagation``) with their split sums
    taken in float64 stay within PROBE_RTOL of float32 (another summation
    order moves them less than the bar), and a copy without the Cw split
    or without the means split lands at least twice the bar away (so the
    probe sees whether a kernel splits them)."""
    _, tm, *_ = short_lanes(rng, 2, **SHORT[case])
    ops = kalman_sym.SymOperators.build(*tm[:6], device="cpu",
                                        dtype=torch.float32)
    s2, R = tm[6], 64
    st = torch.as_tensor(rng.integers(0, 2, R))
    c0 = ops.c0[st][:, None, :].expand(R, s2.shape[0], -1)
    c = (c0 @ ops.Pall.T).view(R, -1, ops.n, ops.PPp)[torch.arange(R), :, st] \
        + ops.sig[st][:, None, :]
    M = 0.3 * torch.as_tensor(rng.normal(size=(R, ops.N1p, 3)), dtype=torch.float32)

    def steps(split):
        Cw, Sinv = kalman_sym.update_contraction(ops, c, s2, split)
        return Cw, Sinv, kalman_sym.mean_propagation(ops, M, st, split)

    def f64_sums(product, a_pair, x):
        a_hi, a_lo = (v.double() for v in a_pair)
        x_hi, x_lo = (v.double() for v in kalman_sym.hi_lo(x))
        return (product(a_hi, x_hi) + product(a_hi, x_lo)
                + product(a_lo, x_hi)).float()

    def r(a, b):
        return float((a - b).abs().max() / b.abs().max())

    split, exact = steps(True), steps(False)
    split_product = kalman_sym.split_product
    kalman_sym.split_product = f64_sums
    try:
        other_order = steps(True)
    finally:
        kalman_sym.split_product = split_product
    assert max(r(a, b) for a, b in zip(other_order, split)) <= PROBE_RTOL
    assert r(exact[0], split[0]) >= 2 * PROBE_RTOL          # Cw
    assert r(exact[2], split[2]) >= 2 * PROBE_RTOL          # the means


def test_split_tier_sensitive_to_summation_order(rng, monkeypatch):
    """The evidence behind RTOL_TPU['split']: the plain version with its
    split products summed in float64 (each product rounded once) moves
    'split' ten times as far as 'split_cov', and each tier's distance to
    bild_tpu is of the size of that move."""
    def f64_sums(product, a_pair, x):
        a_hi, a_lo = (v.double() for v in a_pair)
        x_hi, x_lo = (v.double() for v in kalman_sym.hi_lo(x))
        return (product(a_hi, x_hi).float() + product(a_hi, x_lo).float()
                + product(a_lo, x_hi).float())

    spread, gap = {t: 0.0 for t in SPLIT}, {t: 0.0 for t in SPLIT}
    for case in CASES.values():
        j32, t32, _ = f32_case(rng, **case)
        ops = kalman_sym.SymOperators.build(*t32[:6], device="cpu",
                                            dtype=torch.float32)
        for tier in SPLIT:
            plain = kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:],
                                                      matmul=tier).numpy()
            with monkeypatch.context() as m:
                m.setattr(kalman_sym, "split_product", f64_sums)
                other = kalman_sym.msrouse_logL_sym_torch(
                    ops, *t32[6:], matmul=tier).numpy()
            want = np.asarray(msrouse_logL_pallas_sym(*j32, interpret=True,
                                                      matmul=tier))
            spread[tier] = max(spread[tier], rel(other, plain))
            gap[tier] = max(gap[tier], rel(plain, want))
    assert spread["split"] >= 10 * spread["split_cov"]
    for tier in SPLIT:
        assert gap[tier] <= 3 * spread[tier], tier


def test_wrapper_resolves_the_single_context(rng, restore_matmul):
    """``matmul=None`` is the 'single' context: under 'auto' the exact
    tier, under an explicit mode that mode. Shapes above the operator
    budget go to the dense route, which is always exact."""
    _, t32, _ = f32_case(rng, T=12, P=5)
    ops = kalman_sym.SymOperators.build(*t32[:6], device="cpu",
                                        dtype=torch.float32)
    plain = {t: kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:], matmul=t)
             for t in kalman_sym.TIERS}
    assert torch.equal(kalman_sym.msrouse_logL_sym(*t32, ops=ops), plain["exact"])
    for mode in SPLIT:
        config.set_rouse_matmul(mode)
        assert torch.equal(kalman_sym.msrouse_logL_sym(*t32, ops=ops), plain[mode])
    assert torch.equal(kalman_sym.msrouse_logL_sym(*t32, ops=ops, matmul="exact"),
                       plain["exact"])
    with pytest.raises(ValueError, match="matmul must be"):
        kalman_sym.msrouse_logL_sym(*t32, ops=ops, matmul="bf16")
    with pytest.raises(ValueError, match="matmul must be"):
        kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:], matmul="auto")
    _, big, *_ = make_case(rng, N=70, T=3, P=2, d=1)
    big = [x.float() if isinstance(x, torch.Tensor) and x.is_floating_point()
           else x for x in big]
    assert not kalman_sym.sym_fits(2, 70, 1, 1, 4, "split")
    assert torch.equal(kalman_sym.msrouse_logL_sym(*big, matmul="split"),
                       kalman_sym.msrouse_logL_dense(*big))


def test_split_layout_and_plan_at_the_lockstep_tile():
    """The split kernel's shared memory at TP=32, n=2, N=20, d=3, q=1
    (each part rounded up to 16 bytes): the ring of 3 stages of a 64 x 32
    hi and lo tile, 3 x 8 KB; the float32 covariances 32 x 228 x 4 (the
    depth 216 padded to whole 32-deep stages, then to 4 mod 32); the
    columns' bf16 pairs, 40 slots (the 5 tiles of 8 that 32 columns in two
    states take at most) x 224 x 2 x 2; the means, Cw, 1/S, ll, Ballw, Gsw,
    w, s2, y and the index table as in the exact tier; U1's S row 216 x 4
    ('split' only); the indices of w's nonzero entries 20 x 4 (and the S
    row's 216 x 4, 'split' only); Cind, the slot list 40 x 4, the tile
    states 5 x 4 (-> 32), the profile states, 4 counts and a full and an
    empty barrier per stage: 113,440 bytes ('split_cov') and 115,168
    ('split'), still two blocks per SM, so 3 stages, and 32-profile tiles.
    A block takes at most 32 columns (tile x q), so three localization
    errors give tiles of 8. At one trajectory (L=1, P=100: one profile a
    block, one block an SM) the ring takes 16 stages. The split tiers take
    float32 only."""
    common = (24576 + 29184 + 35840 + 2 * 8064 + 2560 + 128 + 128 + 3360 + 512
              + 80 + 16 + 16 + 432 + 80 + 16 + 160 + 32 + 128 + 16 + 48)
    for tier, want in (("split_cov", common), ("split", common + 2 * 864)):
        assert kalman_sym.sym_smem_bytes(32, 2, 20, 3, 1, 4, tier) == want
        plan = kalman_sym.sym_plan(640, 128, 2, 20, 3, 1, 4, tier=tier)
        assert plan.tile == 32 and plan.smem == want
        assert plan.stages == 3
        one = kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4, tier=tier)
        assert (one.tile, one.stages) == (1, 16)
        assert 2 * (plan.smem + 1024) <= kalman_sym.SMEM_PER_SM
        assert kalman_sym.sym_plan(640, 128, 2, 20, 3, 3, 4, tier=tier).tile == 8
        assert not kalman_sym.sym_fits(2, 20, 3, 1, 8, tier)
    assert common == 113440
    assert kalman_sym.split_ld(216) == 228 and kalman_sym.split_ld(40) == 68
    # the exact tier's, with its float64 covariance (test_torch_kalman_sym)
    assert kalman_sym.sym_smem_bytes(32, 2, 20, 3, 1, 4) == 165696


def test_model_lockstep_closure_follows_the_tier(restore_matmul):
    """`lockstep_fns` keys its closure on (kernel, resolved tier): a new
    closure after `set_rouse_matmul`, the same one while the tier holds
    ('auto' at T=100 is 'split'); past SPLIT_MAX_T 'auto' resolves to
    the exact tier's closure. `lockstep_fns_single` keys on the 'single'
    context."""
    model = bt.models.MultiStateRouse(6, 1.0, 4.0, d=3, localization_error=0.1,
                                      device="cpu", dtype=torch.float32)
    profiles = np.zeros((2, 100), dtype=int)
    batch = model.trajectories_from_loopingprofiles(
        profiles, generator=torch.Generator().manual_seed(0))
    long = model.trajectories_from_loopingprofiles(
        np.zeros((2, 200), dtype=int), generator=torch.Generator().manual_seed(0))
    traj = bt.Trajectory(batch.data[0], batch.valid[0])
    config.set_rouse_matmul("auto")
    auto = model.lockstep_fns(batch)[1]
    assert model.lockstep_fns(batch)[1] is auto
    auto_single = model.lockstep_fns_single(traj)[1]
    config.set_rouse_matmul("split")
    assert model.lockstep_fns(batch)[1] is auto          # both resolve to 'split'
    assert model.lockstep_fns_single(traj)[1] is not auto_single
    config.set_rouse_matmul("exact")
    exact = model.lockstep_fns(batch)[1]
    assert exact is not auto
    assert model.lockstep_fns_single(traj)[1] is auto_single
    config.set_rouse_matmul("auto")
    assert model.lockstep_fns(long)[1] is exact          # T=200 > SPLIT_MAX_T


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_model_ignores_the_tier(restore_matmul, dtype):
    """A model on the CPU runs the plain recursion whatever the tier, as
    bild_tpu keeps its XLA scan on the CPU: no bit moves."""
    model = bt.models.MultiStateRouse(8, 1.0, 4.0, d=3, localization_error=0.1,
                                      device="cpu", dtype=dtype)
    truths = np.zeros((3, 30), dtype=int)
    truths[:, 10:20] = 1
    batch = model.trajectories_from_loopingprofiles(
        truths, generator=torch.Generator().manual_seed(1))
    prof = torch.as_tensor(np.random.default_rng(0).integers(0, 2, (3, 9, 30)),
                           dtype=torch.int32)
    traj = bt.Trajectory(batch.data[0], batch.valid[0])
    got = {}
    for mode in config.MATMUL_MODES:
        config.set_rouse_matmul(mode)
        _, fn = model.lockstep_fns(batch)
        got[mode] = (fn(prof, (batch.data, batch.valid)),
                     model.logL_batch(prof[0], traj))
    for mode in config.MATMUL_MODES[1:]:
        for a, b in zip(got[mode], got["auto"]):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", SPLIT)
def test_cuda_split_kernel_matches_plain(rng, cuda, tier):
    """The tensor-core kernel against its plain version (float32, T=100):
    'split_cov' at rtol 1e-4; 'split' within twice the plain version's
    own error against the float64 build (the kernel is no less accurate
    than its plain version; see RTOL_TPU for why rtol cannot hold it).
    Neither bar tells the tiers apart:
    test_cuda_split_kernel_at_short_length does."""
    _, targs, *_ = make_case(rng, N=20, T=100, P=100, missing=(0, 9),
                             locerr=(0.1, 0.2, 0.1), bad_rows=(7,))
    t32 = [x.to(cuda, torch.float32) if isinstance(x, torch.Tensor)
           and x.is_floating_point() else x for x in targs]
    t32[8] = t32[8].to(cuda, torch.int32)
    t32[10] = t32[10].to(cuda)
    t64 = [x.double() if isinstance(x, torch.Tensor) and x.is_floating_point()
           else x for x in t32]
    ops = kalman_sym.SymOperators.build(*t32[:6], device=cuda,
                                        dtype=torch.float32)
    ops64 = kalman_sym.SymOperators.build(*t32[:6], device=cuda,
                                          dtype=torch.float64)
    launches = kalman_sym.msrouse_logL_sym.split_launches
    got = kalman_sym.msrouse_logL_sym(*t32, ops=ops, matmul=tier).cpu().numpy()
    assert kalman_sym.msrouse_logL_sym.split_launches == launches + 1
    want = kalman_sym.msrouse_logL_sym_torch(ops, *t32[6:], matmul=tier).cpu().numpy()
    f64 = kalman_sym.msrouse_logL_sym(*t64, ops=ops64).cpu().numpy()
    bar = 1e-4 if tier == "split_cov" else max(1e-4, 2 * rel(want, f64))
    assert rel(got, want) <= bar
    assert np.isnan(got[7]) and np.isfinite(np.delete(got, 7)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", SPLIT)
def test_cuda_split_kernel_at_short_length(rng, cuda, tier):
    """At its `SHORT_T` frames the tensor-core kernel is within RTOL_SHORT
    of its plain version, and its shift from the exact kernel follows the
    plain shift (slope within SLOPE): a kernel that skipped a split product
    or computed another tier fails."""
    _, tm, prof, ydata, valid = short_lanes(rng, SHORT_T[tier], bad=True)
    tm = [x.to(cuda) for x in tm[:7]] + [tm[7]]
    lanes = (torch.as_tensor(prof, device=cuda), torch.as_tensor(ydata, device=cuda),
             torch.as_tensor(valid, device=cuda))
    ops = kalman_sym.SymOperators.build(*tm[:6], device=cuda,
                                        dtype=torch.float32)
    kern, plain = ({t: fn(t).double().cpu().numpy() for t in kalman_sym.TIERS}
                   for fn in (lambda t: kalman_sym.msrouse_logL_sym(
                                  *tm, *lanes, ops=ops, matmul=t),
                              lambda t: kalman_sym.msrouse_logL_sym_torch(
                                  ops, *tm[6:], *lanes, matmul=t)))
    assert rel(kern[tier], plain[tier], floor=1.0) <= RTOL_SHORT
    slope = shift_slope(kern[tier] - kern["exact"], plain[tier] - plain["exact"])
    assert SLOPE[0] <= slope <= SLOPE[1]
    assert np.isnan(kern[tier][2, 3]) and np.isnan(kern[tier][5, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("tier", SPLIT)
def test_cuda_split_lanes_bit_for_bit(rng, cuda, tier):
    """A lane-batched launch against one single-lane launch per lane, a
    permutation of the profiles and a subset of them: the same bits."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=6, N=20,
                                                      T=100, P=37)
    model = [x.to(cuda, torch.float32) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=torch.float32),
                 torch.as_tensor(valid, device=cuda))
    ops = kalman_sym.SymOperators.build(*model[:6], device=cuda,
                                        dtype=torch.float32)

    def run(p, y, v):
        return kalman_sym.msrouse_logL_sym(*model, p, y, v, ops=ops,
                                           matmul=tier).cpu().numpy()

    got = run(*lane_args)
    for i in range(6):
        np.testing.assert_array_equal(run(*(x[i] for x in lane_args)), got[i])
    perm = torch.randperm(37, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        run(lane_args[0][:, perm].contiguous(), *lane_args[1:]), got[:, perm])
    np.testing.assert_array_equal(
        run(lane_args[0][:, 3:10].contiguous(), *lane_args[1:]), got[:, 3:10])
