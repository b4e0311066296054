"""The dense-covariance likelihood (`bild_tpu_torch.ops.kalman_dense`): its
plain version against bild_tpu's Pallas kernel (`ops/kalman_pallas.py`) in
interpret mode, the wrapper's dispatch and shared-memory bound, and (on a
GPU) the CUDA kernel against the plain version."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bild_tpu.ops.kalman_pallas import msrouse_logL_pallas
from bild_tpu_torch.ops import kalman_dense, kalman_sym
from test_torch_kalman import LAUNCHES, covers_once, make_case, make_lane_case

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
    jargs, targs, *_ = make_case(rng, **CASES[case])
    want = np.asarray(msrouse_logL_pallas(*jargs, interpret=True))
    got = kalman_dense.msrouse_logL_dense_torch(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))


def test_wrapper_on_cpu_runs_the_plain_version(rng):
    _, targs, *_ = make_case(rng, T=8, P=4)
    launches = kalman_dense.msrouse_logL_dense.launches
    calls = kalman_dense.msrouse_logL_dense_torch.calls
    got = kalman_dense.msrouse_logL_dense(*targs)
    assert kalman_dense.msrouse_logL_dense_torch.calls == calls + 1
    assert kalman_dense.msrouse_logL_dense.launches == launches
    assert torch.equal(got, kalman_dense.msrouse_logL_dense_torch(*targs))


# One block of one warp, n=2 states (csrc/kalman_dense.cu, each part
# rounded up to 16 bytes). N=20, q=1, float32 with the float64 covariance,
# operators in shared memory: B, Sig 2 x 2 x 400 x 4, G 2 x 20 x 3 x 4, w
# 80, s2 16, Cind 16; the warp's C and the scratch (X^T) 2 x 400 x 8, M
# and Mn 2 x 60 x 4: 6992 + 6880. N=20, q=3, float64: 13968 + (3 x 400 +
# 400 + 2 x 60) x 8. N=119, q=3, float32 with the float32 covariance (the
# large-N plan), the operators in global memory (NP = 120) and so no Mn:
# w 480, s2 16, Cind 16, and (3 x 14400 + 14400 + 360) x 4 = 231840.
@pytest.mark.parametrize("N,d,q,itemsize,cov_itemsize,ops_shared,nbytes", [
    (20, 3, 1, 4, 8, True, 13872), (20, 3, 3, 8, 8, True, 27728),
    (119, 3, 3, 4, 4, False, 232352)])
def test_shared_memory_bytes(N, d, q, itemsize, cov_itemsize, ops_shared,
                             nbytes):
    assert kalman_dense.dense_smem_bytes(N, d, q, itemsize,
                                         ops_shared=ops_shared,
                                         cov_itemsize=cov_itemsize) == nbytes
    assert (nbytes <= kalman_dense.SMEM_LIMIT) is True


def test_shared_memory_limit_is_hopper_block_maximum():
    assert kalman_dense.SMEM_LIMIT == 227 * 1024
    assert kalman_dense.dense_smem_bytes(121, 3, 3, 4, ops_shared=False,
                                         cov_itemsize=4) \
        > kalman_dense.SMEM_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 2e-5), (torch.float64, 1e-9)])
def test_cuda_kernel_matches_plain(rng, cuda, dtype, rtol):
    _, targs, *_ = make_case(rng, N=20, T=100, P=100, missing=(0, 9),
                             locerr=(0.1, 0.2, 0.1), bad_rows=(7,))
    targs = [x.to(cuda, dtype) if isinstance(x, torch.Tensor)
             and x.is_floating_point() else x for x in targs]
    targs[8] = targs[8].to(cuda, torch.int32)
    targs[10] = targs[10].to(cuda)
    launches = kalman_dense.msrouse_logL_dense.launches
    got = kalman_dense.msrouse_logL_dense(*targs).cpu()
    assert kalman_dense.msrouse_logL_dense.launches == launches + 1
    want = kalman_dense.msrouse_logL_dense_torch(*targs).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol)
    assert torch.isnan(got[7]) and torch.isfinite(got[:7]).all()


@pytest.mark.cuda
def test_cuda_rejects_oversized_shared_memory(rng, cuda):
    _, targs, *_ = make_case(rng, N=121, T=3, P=2, locerr=(0.1, 0.2, 0.3))
    targs = [x.to(cuda, torch.float32) if isinstance(x, torch.Tensor)
             and x.is_floating_point() else x for x in targs]
    targs[8] = targs[8].to(cuda, torch.int32)
    targs[10] = targs[10].to(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        kalman_dense.msrouse_logL_dense(*targs)


def test_plain_lanes_match_pallas_interpret_per_lane(rng):
    """Lanes whose missing frames differ (one misses its first frame)."""
    jargs, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=3, N=6,
                                                          T=12, P=5)
    lane_args = (torch.as_tensor(prof), torch.as_tensor(ydata),
                 torch.as_tensor(valid))
    got = kalman_dense.msrouse_logL_dense_torch(*targs, *lane_args).numpy()
    for lane in range(3):
        want = np.asarray(msrouse_logL_pallas(*jargs, jnp.asarray(prof[lane]), jnp.asarray(ydata[lane]), jnp.asarray(valid[lane]), interpret=True))
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
    got = kalman_dense.msrouse_logL_dense(*model, *lane_args)
    want = kalman_dense.msrouse_logL_dense_torch(*model, *lane_args)
    singles = [kalman_dense.msrouse_logL_dense(*model, *(x[i] for x in lane_args))
               for i in range(6)]
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    for i, one in enumerate(singles):
        np.testing.assert_array_equal(one.cpu().numpy(), got[i])


def dense_edge(n, q, itemsize, cov_itemsize=None):
    """The largest N one warp of the dense kernel takes (d=3), with the
    operators in global memory and a ``cov_itemsize``-byte covariance
    (default ``itemsize``: the narrowest, the large-N plan of float32)."""
    cov = itemsize if cov_itemsize is None else cov_itemsize
    return max(N for N in range(1, 200)
               if kalman_dense.dense_smem_bytes(N, 3, q, itemsize, n, 1, False,
                                                cov)
               <= kalman_dense.SMEM_LIMIT)


def block_items(plan, b, L, P):
    """The ``lane * P + profile`` items that block ``b`` of the dense
    kernel evaluates: warp w takes item ``b * warps + w``
    (csrc/kalman_dense.cu)."""
    return range(b * plan.warps, min((b + 1) * plan.warps, L * P))


@pytest.mark.parametrize("L,P", LAUNCHES)
def test_plan_places_every_launch(L, P):
    """At every launch shape, in float32 and float64, q in {1, 3}, n in {2,
    3}: at N=20, at the first N the packed kernel sends here, at the
    largest N one warp of float64 covariance takes, one N more and at the
    largest N one warp takes, the block fits the shared memory, has at
    least one warp, and the grid covers every (lane, profile) exactly
    once; the covariance is float64 up to its edge and the inputs' type
    beyond; one N more than the largest raises."""
    for itemsize, n, q in itertools.product((4, 8), (2, 3), (1, 3)):
        edge = dense_edge(n, q, itemsize)
        cov_edge = dense_edge(n, q, itemsize, 8)
        past_sym = 1 + max(N for N in range(1, 100)
                           if kalman_sym.sym_fits(n, N, 3, q, itemsize))
        assert past_sym <= cov_edge <= edge
        for N in (20, past_sym, cov_edge, min(cov_edge + 1, edge), edge):
            plan = kalman_dense.dense_plan(L, P, n, N, 3, q, itemsize)
            assert plan.cov_itemsize == (8 if N <= cov_edge else itemsize)
            assert plan.warps >= 1
            assert plan.smem == kalman_dense.dense_smem_bytes(
                N, 3, q, itemsize, n, plan.warps, plan.ops_shared,
                plan.cov_itemsize)
            assert plan.smem <= kalman_dense.SMEM_LIMIT
            assert covers_once([block_items(plan, b, L, P)
                                for b in range(plan.blocks)], L * P)
        with pytest.raises(ValueError, match="shared memory"):
            kalman_dense.dense_plan(L, P, n, edge + 1, 3, q, itemsize)


# The largest N one warp takes, n=2, d=3. The first dense kernel (a block
# of 256 threads per profile, C and X unpadded in shared memory) took 168,
# 119, 118 and 83: float64 at q=1 loses N = 117, 118 to the padding of N
# to a multiple of 4.
@pytest.mark.parametrize("q,itemsize,edge", [
    (1, 4, 168), (3, 4, 120), (1, 8, 116), (3, 8, 84)])
def test_plan_range(q, itemsize, edge):
    """The chains the dense kernel takes: the operators sit in shared
    memory at N=20 and in global memory at the largest N."""
    assert dense_edge(2, q, itemsize) == edge
    assert kalman_dense.dense_plan(640, 128, 2, 20, 3, q, itemsize).ops_shared
    assert not kalman_dense.dense_plan(640, 128, 2, edge, 3, q,
                                       itemsize).ops_shared


def test_plan_warps():
    """Eight warps per block at the lockstep launch; one profile per block
    for a single-trajectory step, so it spreads over the SMs."""
    assert kalman_dense.dense_plan(640, 128, 2, 20, 3, 1, 4).warps == 8
    single = kalman_dense.dense_plan(1, 100, 2, 20, 3, 1, 4)
    assert single.warps == 1 and single.blocks == 100


@pytest.mark.cuda
def test_cuda_warps_per_block_change_no_bit(rng, cuda):
    """A profile's result does not depend on its block partners: 80 lanes
    of 128 profiles run 8 warps per block, each lane alone one warp per
    block, with the same bits."""
    _, targs, prof, ydata, valid, *_ = make_lane_case(rng, L=80, N=20,
                                                      T=100, P=128)
    model = [x.to(cuda, torch.float32) for x in targs[:7]] + [targs[7]]
    lane_args = (torch.as_tensor(prof, device=cuda),
                 torch.as_tensor(ydata, device=cuda, dtype=torch.float32),
                 torch.as_tensor(valid, device=cuda))
    assert kalman_dense.dense_plan(80, 128, 2, 20, 3, 2, 4).warps == 8  # q = 2
    assert kalman_dense.dense_plan(1, 128, 2, 20, 3, 2, 4).warps == 1
    got = kalman_dense.msrouse_logL_dense(*model, *lane_args).cpu()
    for i in (0, 1, 40, 79):
        one = kalman_dense.msrouse_logL_dense(
            *model, *(x[i] for x in lane_args)).cpu()
        np.testing.assert_array_equal(one.numpy(), got[i].numpy())
