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
    tiles_per_lane`` (csrc/kalman_sym.cu)."""
    lane, t = divmod(b, plan.tiles_per_lane)
    return range(lane * P + t * plan.tile, lane * P + min((t + 1) * plan.tile, P))


def sym_edge(n, q, itemsize):
    """The largest N the packed kernel takes (d=3)."""
    return max(N for N in range(1, 100)
               if kalman_sym.sym_fits(n, N, 3, q, itemsize))


@pytest.mark.parametrize("L,P", LAUNCHES)
def test_plan_places_every_launch(L, P):
    """At every launch shape, in float32 and float64, q in {1, 3}, n in {2,
    3}, at N=20 and at the edge of the operator budget: the tile fits the
    shared memory, holds at least one profile, and the grid covers every
    (lane, profile) exactly once. One N past the edge goes to the dense
    route."""
    for itemsize, n, q in itertools.product((4, 8), (2, 3), (1, 3)):
        edge = sym_edge(n, q, itemsize)
        assert not kalman_sym.sym_fits(n, edge + 1, 3, q, itemsize)
        for N in (20, edge):
            plan = kalman_sym.sym_plan(L, P, n, N, 3, q, itemsize)
            assert plan.tile >= 1
            assert plan.smem == kalman_sym.sym_smem_bytes(plan.tile, n, N, 3,
                                                          q, itemsize)
            assert plan.smem <= kalman_dense.SMEM_LIMIT
            assert plan.blocks == L * plan.tiles_per_lane
            assert covers_once([block_items(plan, b, P)
                                for b in range(plan.blocks)], L * P)


def test_plan_tiles():
    """The lockstep launch gets 32-profile tiles with two blocks resident
    per SM; a single-trajectory step spreads one profile per block;
    float64 takes narrower tiles."""
    lock = kalman_sym.sym_plan(640, 128, 2, 20, 3, 1, 4)
    assert lock.tile == 32 and lock.blocks == 2560
    assert 2 * (lock.smem + 1024) <= kalman_dense.SMEM_PER_SM
    assert kalman_sym.sym_plan(1, 100, 2, 20, 3, 1, 4).blocks == 100
    assert kalman_sym.sym_plan(640, 128, 2, 20, 3, 1, 8).tile < 32


def test_smem_bytes_at_the_lockstep_tile():
    """The layout of csrc/kalman_sym.cu at TP=32, n=2, N=20, d=3, q=1,
    float32 (each part rounded up to 16 bytes): c and cn 2 x 32 x 220 x 4,
    the slabs 2 x 2 x 216 x 8 x 4, M and Mn 2 x 32 x 21 x 3 x 4, Cw 32 x 20
    x 4, 1/S and ll 2 x 32 x 4, Ballw 2 x 21 x 20 x 4, Gsw 2 x 21 x 3 x 4
    (504 -> 512), w 80, s2 16, y 16, the index table 420 -> 432, Cind 16,
    the lists 160 + 48 + 128, the counts 16, the two slab barriers 16."""
    want = (56320 + 27648 + 16128 + 2560 + 256 + 3360 + 512 + 80 + 16 + 16
            + 432 + 16 + 160 + 48 + 128 + 16 + 16)
    assert kalman_sym.sym_smem_bytes(32, 2, 20, 3, 1, 4) == want == 107712


@pytest.mark.cuda
def test_cuda_tile_width_changes_no_bit(rng, cuda):
    """A profile's result does not depend on the tile it shares: 80 lanes
    of 128 profiles run in tiles of 16, each lane alone one profile per
    block, with the same bits."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=80, N=20,
                                                      T=100, P=128)
    model = [x.to(cuda, torch.float32) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=torch.float32),
                 torch.as_tensor(valid, device=cuda))
    assert kalman_sym.sym_plan(80, 128, 2, 20, 3, 2, 4).tile == 16  # q = 2
    assert kalman_sym.sym_plan(1, 128, 2, 20, 3, 2, 4).tile == 1
    ops = kalman_sym.SymOperators.build(*model[:6], device=cuda,
                                        dtype=torch.float32)
    got = kalman_sym.msrouse_logL_sym(*model, *lane_args, ops=ops).cpu()
    for i in (0, 1, 40, 79):
        one = kalman_sym.msrouse_logL_sym(*model, *(x[i] for x in lane_args),
                                          ops=ops).cpu()
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())
