"""The packed-symmetric likelihood (`bild_tpu_torch.ops.kalman_sym`): its
plain version against bild_tpu's Pallas kernel in interpret mode, the
operator construction, the wrapper's dispatch, and (on a GPU) the CUDA
kernel against the plain version."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu.ops.kalman_sym import (_build_sym_operators,
                                     msrouse_logL_pallas_sym)
from bild_tpu_torch.ops import kalman_dense, kalman_sym
from test_torch_kalman import LAUNCHES, covers_once, make_case, make_lane_case

# the bound of tests/test_kalman_sym.py: the packed form is exact algebra
RTOL = 1e-9

CASES = {
    "q=3 missing frames": dict(locerr=(0.1, 0.2, 0.1), missing=(0, 5, 17)),
    "n=3": dict(loops=(None, (0, -1), (0, 4)), N=10, T=30),
    "small P": dict(P=3, T=12),
    "NaN rows": dict(bad_rows=(1, 4), P=9),
    "d=1": dict(d=1, locerr=0.3, N=8),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(rng, case):
    jargs, targs, prof, *_ = make_case(rng, **CASES[case])
    want = np.asarray(msrouse_logL_pallas_sym(*jargs, interpret=True))
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float64)
    got = kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("N,n", [(9, 2), (6, 3), (1, 2)])
def test_operators_equal_bild_tpu(rng, N, n):
    Bs = rng.normal(size=(n, N, N))
    Sigs = rng.normal(size=(n, N, N))
    C0s = rng.normal(size=(n, N, N))
    Gs, M0s = rng.normal(size=(n, N, 2)), rng.normal(size=(n, N, 2))
    w = rng.normal(size=N)
    got = kalman_sym.build_sym_operators(Bs, Gs, Sigs, M0s, C0s, w)
    want = _build_sym_operators(Bs, Gs, Sigs, M0s, C0s, w)
    assert got[7:] == want[7:]                      # PPp, (S_OFF, N1p)
    for g, wnt in zip(got[:7], want[:7]):
        np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_slab_operators_hold_pall(rng, itemsize):
    """The kernel-order copy of the propagators: slab kb of state s holds
    columns 8 kb .. 8 kb + 7 of every row, each row's 16-byte chunks at
    their swizzled places (2 chunks a row in float32, 4 in float64)."""
    n, PPp = 2, 24
    Pall = rng.normal(size=(n * PPp, PPp))
    got = kalman_sym.slab_operators(Pall, n, PPp, itemsize)
    CH = 8 * itemsize // 16
    vw = 8 // CH
    back = np.empty((n, PPp, PPp))
    for kb in range(PPp // 8):
        for r in range(PPp):
            for ch in range(CH):
                dest = ch ^ ((r // (8 // CH)) % CH)
                back[:, r, 8 * kb + ch * vw:8 * kb + (ch + 1) * vw] = \
                    got[:, kb, r, dest * vw:(dest + 1) * vw]
    np.testing.assert_array_equal(back.reshape(n * PPp, PPp), Pall)


def test_operators_on_the_cpu(rng):
    """Operators built for the CPU carry no kernel-order copy; the plain
    version's Pall and U1 are made from the host arrays on first use."""
    _, targs, *_ = make_case(rng, N=6, T=8, P=4)
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float32)
    assert ops.Pslab is None
    Pall, _, _, U1, *_ = kalman_sym.build_sym_operators(*targs[:6])
    assert ops.Pall.dtype == torch.float32 and ops.Pall.device.type == "cpu"
    np.testing.assert_array_equal(ops.Pall.numpy(), Pall.astype(np.float32))
    np.testing.assert_array_equal(ops.U1.numpy(), U1.astype(np.float32))
    assert ops.Pall is ops.Pall


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    _, targs, *_ = make_case(rng, T=8, P=4)
    launches = kalman_sym.msrouse_logL_sym.launches
    calls = kalman_sym.msrouse_logL_sym_torch.calls
    got = kalman_sym.msrouse_logL_sym(*targs)
    assert kalman_sym.msrouse_logL_sym_torch.calls == calls + 1
    assert kalman_sym.msrouse_logL_sym.launches == launches
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float64)
    assert torch.equal(got, kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:]))


@pytest.mark.parametrize("n,N,itemsize,fits", [
    (2, 20, 4, True), (2, 53, 4, True), (2, 54, 4, False),
    (3, 48, 4, True), (3, 49, 4, False), (2, 44, 8, True), (2, 45, 8, False)])
def test_sym_fits_operator_budget(n, N, itemsize, fits):
    assert kalman_sym.sym_fits(n, N, 3, 1, itemsize) is fits


def test_large_chains_fall_back_to_dense(rng):
    """Above the operator budget the wrapper runs the dense likelihood (on
    the CPU its plain version), without building packed operators."""
    _, targs, *_ = make_case(rng, N=70, T=3, P=2, d=1)
    calls = kalman_dense.msrouse_logL_dense_torch.calls
    got = kalman_sym.msrouse_logL_sym(*targs, ops=None)
    assert kalman_dense.msrouse_logL_dense_torch.calls == calls + 1
    want = kalman_dense.msrouse_logL_dense_torch(*targs)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-9)])
def test_cuda_kernel_matches_plain(rng, cuda, dtype, rtol):
    _, targs, *_ = make_case(rng, N=20, T=100, P=100, missing=(0, 9),
                             locerr=(0.1, 0.2, 0.1), bad_rows=(7,))
    targs = [x.to(cuda, dtype) if isinstance(x, torch.Tensor)
             and x.is_floating_point() else x for x in targs]
    targs[8] = targs[8].to(cuda, torch.int32)
    targs[10] = targs[10].to(cuda)
    ops = kalman_sym.SymOperators.build(*targs[:6], device=cuda, dtype=dtype)
    launches = kalman_sym.msrouse_logL_sym.launches
    got = kalman_sym.msrouse_logL_sym(*targs, ops=ops).cpu()
    assert kalman_sym.msrouse_logL_sym.launches == launches + 1
    want = kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:]).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol)
    assert torch.isnan(got[7]) and torch.isfinite(got[:7]).all()


def test_plain_lanes_match_pallas_interpret_per_lane(rng):
    """Lanes whose missing frames differ (one misses its first frame)."""
    jargs, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=3, N=6,
                                                          T=12, P=5)
    lane_args = (torch.as_tensor(prof), torch.as_tensor(ydata),
                 torch.as_tensor(valid))
    ops = kalman_sym.SymOperators.build(*targs[:6], device="cpu",
                                        dtype=torch.float64)
    got = kalman_sym.msrouse_logL_sym_torch(ops, *targs[6:], *lane_args).numpy()
    for lane in range(3):
        want = np.asarray(msrouse_logL_pallas_sym(*jargs, jnp.asarray(prof[lane]), jnp.asarray(ydata[lane]), jnp.asarray(valid[lane]), interpret=True))
        np.testing.assert_allclose(got[lane], want, rtol=RTOL)
        assert np.array_equal(np.isnan(got[lane]), np.isnan(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-9)])
def test_cuda_lanes_match_plain_and_single_lanes(rng, cuda, dtype, rtol):
    """One lane-batched launch against its plain version, and bit for bit
    against one single-lane launch per lane."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=6, N=20,
                                                      T=100, P=37)
    model = [x.to(cuda, dtype) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=dtype),
                 torch.as_tensor(valid, device=cuda))
    ops = kalman_sym.SymOperators.build(*model[:6], device=cuda, dtype=dtype)
    got = kalman_sym.msrouse_logL_sym(*model, *lane_args, ops=ops)
    want = kalman_sym.msrouse_logL_sym_torch(ops, *model[6:], *lane_args)
    singles = [kalman_sym.msrouse_logL_sym(*model, *(x[i] for x in lane_args), ops=ops)
               for i in range(6)]
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    for i, one in enumerate(singles):
        np.testing.assert_array_equal(one.cpu().numpy(), got[i])


def block_items(plan, b, P):
    """The ``lane * P + profile`` items that block ``b`` of the packed
    kernel evaluates: tile ``b % tiles_per_lane`` of lane ``b //
    tiles_per_lane`` (csrc/kalman_sym.cu); in the cluster plan, ``b`` is
    a cluster (its C blocks evaluate the same items)."""
    lane, t = divmod(b, plan.tiles_per_lane)
    return range(lane * P + t * plan.tile, lane * P + min((t + 1) * plan.tile, P))


def plan_items(plan, P):
    """The items of every block of the tile plan, or of every cluster of
    the cluster plan."""
    units = plan.blocks // max(plan.cluster, 1)
    return [block_items(plan, b, P) for b in range(units)]


# the launch shapes of the plan tests: every lane shape of the likelihood
# tests and the single-trajectory steps around sample()'s (L=1, P=100)
SYM_LAUNCHES = LAUNCHES + [(1, P) for P in (1, 9, 37, 128)]


def sym_edge(n, q, itemsize):
    """The largest N the packed kernel takes (d=3)."""
    return max(N for N in range(1, 100)
               if kalman_sym.sym_fits(n, N, 3, q, itemsize))


@pytest.mark.parametrize("L,P", SYM_LAUNCHES)
def test_plan_places_every_launch(L, P):
    """At every launch shape, in float32 and float64, q in {1, 3}, n in {2,
    3}, at N=20 and at the edge of the operator budget: the tile fits the
    shared memory, holds at least one profile, and the grid (of blocks, or
    of clusters in the cluster plan) covers every (lane, profile) exactly
    once. One N past the edge goes to the dense route."""
    for itemsize, n, q in itertools.product((4, 8), (2, 3), (1, 3)):
        edge = sym_edge(n, q, itemsize)
        assert not kalman_sym.sym_fits(n, edge + 1, 3, q, itemsize)
        for N in (20, edge):
            plan = kalman_sym.sym_plan(L, P, n, N, 3, q, itemsize)
            assert plan.tile >= 1
            assert plan.smem == kalman_sym.sym_smem_bytes(
                plan.tile, n, N, 3, q, itemsize, cluster=plan.cluster)
            assert plan.smem <= kalman_dense.SMEM_LIMIT
            assert plan.blocks == L * plan.tiles_per_lane * max(plan.cluster, 1)
            assert covers_once(plan_items(plan, P), L * P)


def cluster_fits(n, N, q, itemsize):
    """Whether some cluster size's operator rows fit one block's shared
    memory beside one profile's replicas."""
    return any(kalman_sym.sym_smem_bytes(1, n, N, 3, q, itemsize, cluster=C)
               <= kalman_dense.SMEM_LIMIT for C in kalman_sym.SYM_CLUSTERS)


@pytest.mark.parametrize("L,P", SYM_LAUNCHES)
def test_cluster_plan_where_sms_idle(L, P):
    """The cluster plan is chosen exactly where one profile per block
    leaves SMs idle (L P < 132) and a cluster's operator rows fit beside
    its replicas (float32 and float64, n in {2, 3}, q in {1, 3}, N=20 and
    the edge); its clusters then run at once on an H100
    (`H100_CLUSTER_SLOTS`) unless a cluster's shared memory holds too few
    profiles. Forced onto the tile plan, the same launch takes the tile
    plan's grid."""
    for itemsize, n, q in itertools.product((4, 8), (2, 3), (1, 3)):
        for N in (20, sym_edge(n, q, itemsize)):
            plan = kalman_sym.sym_plan(L, P, n, N, 3, q, itemsize)
            tile = kalman_sym.sym_plan(L, P, n, N, 3, q, itemsize, _force="tile")
            assert tile.cluster == 0
            want = (L * P < kalman_dense.H100_SMS
                    and cluster_fits(n, N, q, itemsize))
            assert bool(plan.cluster) == want, (itemsize, n, q, N)
            if not want:
                assert plan == tile
                continue
            clusters = plan.blocks // plan.cluster
            slots = kalman_sym.H100_CLUSTER_SLOTS[plan.cluster]
            wider = kalman_sym.sym_smem_bytes(plan.tile + 1, n, N, 3, q, itemsize,
                                              cluster=plan.cluster)
            assert clusters <= max(slots, L) or wider > kalman_dense.SMEM_LIMIT


@pytest.mark.parametrize("N,C", [(20, 8), (20, 16), (3, 8), (1, 16), (48, 8),
                                 (53, 16)])
def test_cluster_rows_cover_every_row(N, C):
    """The blocks of a cluster own contiguous operator rows, together
    every row of the PP exactly once, at most ceil(PP / C) each."""
    PP = N * (N + 1) // 2
    rows = kalman_sym.cluster_rows(PP, C)
    assert len(rows) == C
    assert all(len(r) <= -(-PP // C) for r in rows)
    assert [r.start for r in rows] == sorted(r.start for r in rows)
    assert covers_once([r for r in rows if len(r)], PP)


def test_cluster_smem_at_the_step():
    """The cluster layout of csrc/kalman_sym.cu at sample()'s step (L=1,
    P=100, n=2, N=20, d=3, q=1, float32 with the float64 covariance):
    clusters of 8 blocks, 7 profiles each (15 clusters, as many as an
    H100 holds at once); per block (each part rounded up to 16 bytes) the
    replicas c and cn 2 x 7 x 218 x 8, its 27 operator rows of both states
    2 x 27 x 220 x 4 and their sig 2 x 27 x 4 (216 -> 224), M and Mn 2 x
    7 x 21 x 3 x 4 (1764 -> 1776), Cw 7 x 20 x 8, 1/S 7 x 8 (56 -> 64),
    ll 7 x 4 (28 -> 32), Ballw 2 x 21 x 20 x 4, Gsw 2 x 21 x 3 x 4 (504
    -> 512), w 80, s2 16, y 16, the index table 420 -> 432, Cind 16, the
    states 28 -> 32, three barriers 24 -> 32: 81,424 bytes, within
    SMEM_LIMIT."""
    plan = kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4)
    assert (plan.cluster, plan.tile, plan.tiles_per_lane, plan.blocks) == (8, 7, 15, 120)
    want = (24416 + 47520 + 224 + 3552 + 1120 + 64 + 32 + 3360 + 512 + 80
            + 16 + 16 + 432 + 16 + 32 + 32)
    assert plan.smem == kalman_sym.sym_smem_bytes(7, 2, 20, 3, 1, 4, cluster=8) \
        == want == 81424
    assert plan.smem <= kalman_dense.SMEM_LIMIT
    # float64: the operator rows (stride 218), their sig, the means,
    # Ballw, Gsw, w and the data double
    f64 = kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 8)
    assert (f64.cluster, f64.tile) == (8, 7)
    assert f64.smem == want + (2 * 27 * 218 * 8 - 47520) + (432 - 224) \
        + 2 * (3536 - 1776) + (64 - 32) + (6720 - 3360) + (1008 - 512) \
        + (160 - 80) + (32 - 16)


def test_forced_plans():
    """The private ``_force`` takes the tile plan, the cluster plan or a
    cluster size wherever it fits, and refuses a cluster that does not."""
    assert kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4, _force="tile").blocks == 100
    lanes = kalman_sym.sym_plan(6, 37, 2, 20, 3, 1, 4, _force="cluster")
    assert lanes.cluster == 8 and lanes.tile == 19 and lanes.blocks == 6 * 2 * 8
    assert kalman_sym.sym_plan(6, 37, 2, 20, 3, 1, 4).cluster == 0
    sixteen = kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4, _force=16)
    assert (sixteen.cluster, sixteen.tile, sixteen.blocks) == (16, 15, 7 * 16)
    assert kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4, cluster_slots=lambda C: 0) \
        == kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4, _force="tile")
    with pytest.raises(ValueError, match="no cluster plan"):
        kalman_sym.sym_plan(1, 100, 2, 53, 3, 1, 4, _force="cluster")


def test_cluster_launches_are_counted():
    """The cluster plan's launches have a counter of their own in the
    registry that the smoke script and the step graphs read."""
    from bild_tpu_torch.ops import counters
    assert counters.COUNTERS["kalman_sym_cluster"] == (
        kalman_sym.msrouse_logL_sym, "cluster_launches")
    assert counters.read(["kalman_sym_cluster"]) == {
        "kalman_sym_cluster": kalman_sym.msrouse_logL_sym.cluster_launches}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_row_operators_hold_pall(rng, itemsize):
    """The cluster plan's copy of the propagators: row r of state s holds
    Pall's row s PPp + r, padded with zeros to a whole 16-byte vector."""
    n, PPp = 3, 24
    Pall = rng.normal(size=(n * PPp, PPp))
    got = kalman_sym.row_operators(Pall, n, PPp, itemsize)
    assert got.shape == (n, PPp, PPp + 16 // itemsize)
    np.testing.assert_array_equal(got[:, :, :PPp].reshape(n * PPp, PPp), Pall)
    assert not got[:, :, PPp:].any()


def test_plan_tiles():
    """The lockstep launch gets 32-profile tiles, one block per SM (the
    float64 covariance's registers leave no room for a second); with a
    float32 covariance (its predecessor's layout) the same tiles kept two
    blocks resident per SM, and a 16-profile config 4 scout tile two; a
    single-trajectory step takes the cluster plan (15 clusters of 8
    blocks, 7 profiles each), and forced onto tiles spreads one profile
    per block; float64 takes the same tiles as float32."""
    lock = kalman_sym.sym_plan(640, 128, 2, 20, 3, 1, 4)
    assert lock.tile == 32 and lock.blocks == 2560
    assert lock.smem + 1024 <= kalman_dense.SMEM_PER_SM < 2 * (lock.smem + 1024)
    old = kalman_sym.sym_plan(640, 128, 2, 20, 3, 1, 4, cov_itemsize=4)
    assert old.tile == 32 and 2 * (old.smem + 1024) <= kalman_dense.SMEM_PER_SM
    assert kalman_sym.sym_plan(112, 128, 3, 20, 3, 1, 4).tile == 32
    assert kalman_sym.sym_plan(112, 128, 3, 20, 3, 1, 4, cov_itemsize=4).tile == 16
    step = kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4)
    assert (step.cluster, step.tile, step.tiles_per_lane, step.blocks) == (8, 7, 15, 120)
    assert kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4, _force="tile").blocks == 100
    assert kalman_sym.sym_plan(640, 128, 2, 20, 3, 1, 8).tile == 32


def test_smem_bytes_at_the_lockstep_tile():
    """The layout of csrc/kalman_sym.cu at TP=32, n=2, N=20, d=3, q=1,
    float32 with the float64 covariance (each part rounded up to 16
    bytes): c and cn 2 x 32 x 218 x 8, the slabs 2 x 2 x 216 x 8 x 4, M
    and Mn 2 x 32 x 21 x 3 x 4, Cw 32 x 20 x 8, 1/S 32 x 8, ll 32 x 4,
    Ballw 2 x 21 x 20 x 4, Gsw 2 x 21 x 3 x 4 (504 -> 512), w 80, s2 16, y
    16, the index table 420 -> 432, Cind 16, the lists 160 + 48 + 128, the
    counts 16, the two slab barriers 16. With a float32 covariance (the
    parent kernel's layout) c and cn take 2 x 32 x 220 x 4, Cw 32 x 20 x 4
    and 1/S 32 x 4."""
    rest = (27648 + 16128 + 128 + 3360 + 512 + 80 + 16 + 16 + 432 + 16 + 160
            + 48 + 128 + 16 + 16)
    want = 111616 + 5120 + 256 + rest
    assert kalman_sym.sym_smem_bytes(32, 2, 20, 3, 1, 4) == want == 165696
    assert kalman_sym.sym_smem_bytes(32, 2, 20, 3, 1, 4, cov_itemsize=4) \
        == 56320 + 2560 + 128 + rest == 107712


@pytest.mark.cuda
def test_cuda_tile_width_changes_no_bit(rng, cuda):
    """A profile's result does not depend on the tile it shares: 80 lanes
    of 128 profiles run in tiles of 16, each lane alone in the cluster
    plan, with the same bits."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=80, N=20,
                                                      T=100, P=128)
    model = [x.to(cuda, torch.float32) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=torch.float32),
                 torch.as_tensor(valid, device=cuda))
    assert kalman_sym.sym_plan(80, 128, 2, 20, 3, 2, 4).tile == 16  # q = 2
    assert kalman_sym.sym_plan(1, 128, 2, 20, 3, 2, 4).cluster
    ops = kalman_sym.SymOperators.build(*model[:6], device=cuda,
                                        dtype=torch.float32)
    got = kalman_sym.msrouse_logL_sym(*model, *lane_args, ops=ops).cpu()
    for i in (0, 1, 40, 79):
        one = kalman_sym.msrouse_logL_sym(*model, *(x[i] for x in lane_args),
                                          ops=ops).cpu()
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L,P", [(1, 1), (1, 7), (1, 100), (2, 37), (6, 37)])
def test_cuda_cluster_plan_equals_tile_plan(rng, cuda, dtype, L, P):
    """The cluster plan gives every profile the bits of the tile plan on
    the same launch (missing frames, the first among them; an
    out-of-range row), forced where the planner would not take it."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(
        rng, L=L, N=20, T=100, P=P, bad=((0, P - 1),),
        loops=(None, (0, -1), (0, 10)))
    model = [x.to(cuda, dtype) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=dtype),
                 torch.as_tensor(valid, device=cuda))
    ops = kalman_sym.SymOperators.build(*model[:6], device=cuda, dtype=dtype)
    counts = kalman_sym.msrouse_logL_sym.cluster_launches
    got = kalman_sym.msrouse_logL_sym(*model, *lane_args, ops=ops, _force="cluster")
    assert kalman_sym.msrouse_logL_sym.cluster_launches == counts + 1
    want = kalman_sym.msrouse_logL_sym(*model, *lane_args, ops=ops, _force="tile")
    assert kalman_sym.msrouse_logL_sym.cluster_launches == counts + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert torch.isnan(got[0, P - 1])
