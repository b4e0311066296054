"""bild_tpu_torch.parallel.sharded (process-local dataset inference) in one
process: the counterparts of tests/test_sharded.py on the port, the driver's
host logic against bild_tpu's under one stubbed `sample_batch`, the
schedule alone, and fault (c) of bild_tpu's driver, which the port raises.
The two-process runs are in tests/test_torch_distributed.py."""
import jax
import numpy as np
import pytest
import torch
from scipy import stats as sp_stats

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu_torch.parallel import (BatchResults, TrajectoryBatch,
                                     sample_batch, sample_dataset_sharded,
                                     stack_trajectories)
from bild_tpu_torch.parallel import sharded as tsh
from bild_tpu_torch.parallel.batch import _informed_proposals_all_k_impl
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)
LENGTHS = (8, 14, 8, 11, 14, 8)
KW = dict(k_max=3, steps_per_k=6, N=24, bucket_edges=(8, 16),
          informed_init=True, marginals=True)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def factorized_data():
    """Six trajectories' values (numpy, d=1) of the two-state factorized
    model of tests/test_sharded.py."""
    np.random.seed(180357)
    model = bt.models.FactorizedModel([sp_stats.maxwell(scale=0.1),
                                       sp_stats.maxwell(scale=1)], d=1, **CPU)
    out = []
    for i, T in enumerate(LENGTHS):
        prof = np.zeros(T, dtype=int)
        if i % 2 == 1:
            prof[T // 2:] = 1
        out.append(model.trajectory_from_loopingprofile(prof, generator=gen(70 + i))[:])
    return out


@pytest.fixture(scope="module")
def factorized_setup():
    model = bt.models.FactorizedModel([sp_stats.maxwell(scale=0.1),
                                       sp_stats.maxwell(scale=1)], d=1, **CPU)
    return model, [bt.Trajectory.create(x, dtype=F64) for x in factorized_data()]


def assert_same(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.evidence, b.evidence)
    np.testing.assert_array_equal(a.evidence_se, b.evidence_se)
    np.testing.assert_array_equal(a.mom_ok, b.mom_ok)
    for x, y in zip(a.profiles_by_k, b.profiles_by_k):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.marginals or (), b.marginals or ()):
        np.testing.assert_array_equal(x, y)


def test_composition_and_order_invariance(factorized_setup):
    """A trajectory's result does not depend on where it lands: other chunk
    sizes and a shuffled shard give the same bits."""
    model, trajs = factorized_setup
    ids = np.array([5, 17, 2, 30, 11, 8])
    r1 = sample_dataset_sharded(model, trajs, ids, chunk_size=2,
                                generator=gen(7), **KW)
    r2 = sample_dataset_sharded(model, trajs, ids, chunk_size=4,
                                generator=gen(7), **KW)
    perm = np.array([4, 2, 0, 5, 1, 3])
    r3 = sample_dataset_sharded(model, [trajs[i] for i in perm], ids[perm],
                                chunk_size=2, generator=gen(7), **KW)
    np.testing.assert_array_equal(r1.ids, np.sort(ids))
    assert np.isfinite(r1.evidence).all() and r1.mom_ok.all()
    for other in (r2, r3):
        assert_same(r1, other)
    # a one-rank mesh is the mesh-free run
    mesh = bt.parallel.make_mesh(devices="cpu")
    assert_same(r1, sample_dataset_sharded(model, trajs, ids, mesh=mesh,
                                           chunk_size=2, generator=gen(7), **KW))


def test_checkpoint_resume(factorized_setup, tmp_path, monkeypatch):
    model, trajs = factorized_setup
    kw = dict(KW, chunk_size=2, checkpoint_dir=str(tmp_path))
    r1 = sample_dataset_sharded(model, trajs, np.arange(6), **kw, generator=gen(9))
    assert len(list(tmp_path.glob("shard_chunk_*.npz"))) == 4

    def no_run(*a, **k):
        raise AssertionError("a chunk was recomputed")

    monkeypatch.setattr(tsh, "sample_batch", no_run)
    r2 = sample_dataset_sharded(model, trajs, np.arange(6), **kw, generator=gen(9))
    assert_same(r1, r2)


def test_argument_guards(factorized_setup):
    model, trajs = factorized_setup
    with pytest.raises(ValueError, match="ids"):
        sample_dataset_sharded(model, trajs, np.arange(3), **KW)
    with pytest.raises(ValueError, match="duplicate"):
        sample_dataset_sharded(model, trajs, np.zeros(6, dtype=int), **KW)
    with pytest.raises(ValueError, match=r"\[0, 2\^31\)"):
        sample_dataset_sharded(model, trajs, np.arange(6) - 3, **KW)
    with pytest.raises(ValueError, match="no trajectories"):
        sample_dataset_sharded(model, [], [], **KW)


def test_row_keys_position_invariance():
    """`sample_batch(row_keys=)`: permuting the rows permutes the results
    exactly."""
    model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=2, localization_error=0.1,
                                      **CPU)
    profs = np.zeros((6, 30), dtype=int)
    profs[::2, 10:20] = 1
    batch = model.trajectories_from_loopingprofiles(profs, generator=gen(1))
    keys = np.array([4, 9, 1, 7, 2, 6], dtype=np.int64) * 1000003
    kw = dict(k_max=2, steps_per_k=4, N=16)
    res = sample_batch(model, batch, **kw, row_keys=keys)
    perm = np.array([3, 1, 5, 0, 2, 4])
    batch_p = TrajectoryBatch(data=batch.data[perm], valid=batch.valid[perm],
                              lengths=np.asarray(batch.lengths)[perm])
    res_p = sample_batch(model, batch_p, **kw, row_keys=keys[perm])
    np.testing.assert_array_equal(res.evidence[perm], res_p.evidence)
    np.testing.assert_array_equal(res.map_profiles[:, perm], res_p.map_profiles)
    # the keys, not the generator, make the streams
    again = sample_batch(model, batch, **kw, row_keys=keys, generator=gen(5))
    np.testing.assert_array_equal(res.evidence, again.evidence)


def test_informed_arrays_injection_matches_host_path(factorized_setup):
    model, trajs = factorized_setup
    batch = stack_trajectories([t for t in trajs if len(t) == 8])
    inf = _informed_proposals_all_k_impl(model, batch, 4, 2, batch.T)
    assert inf is not None
    kw = dict(k_max=3, steps_per_k=4, N=16)
    r_host = sample_batch(model, batch, **kw, generator=gen(2), informed_init=True)
    r_inj = sample_batch(model, batch, **kw, generator=gen(2), informed_arrays=inf)
    np.testing.assert_array_equal(r_host.evidence, r_inj.evidence)
    np.testing.assert_array_equal(r_host.map_profiles, r_inj.map_profiles)
    with pytest.raises(ValueError, match="informed_arrays"):
        sample_batch(model, batch, k_max=3, steps_per_k=4, N=16,
                     informed_arrays=inf, checkpoint="x.npz")


def stub_sample_batch(model, batch, k_max=10, marginals=False, **kw):
    """A deterministic stand-in for `sample_batch` whose outputs are made
    from the batch's true lengths, as both packages' drivers call it."""
    lengths = np.asarray(batch.lengths)
    B, T = len(lengths), batch.data.shape[1]
    K = min(k_max, T - 1) + 1
    ev = lengths[:, None] * 10.0 + np.arange(K)[None]
    maps = (np.arange(T)[None, None, :] + lengths[None, :, None]
            + np.arange(K)[:, None, None]) % 2
    marg = (np.log(np.full((K, B, 2, T), 0.5)) - lengths[None, :, None, None]
            if marginals else None)
    return BatchResults(k=np.arange(K), evidence=ev, evidence_se=ev / 100,
                        map_profiles=maps, marginals=marg,
                        mom_ok=(lengths[:, None] + np.arange(K)) % 3 > 0)


def test_host_logic_matches_bild_tpu(monkeypatch):
    """The drivers' host logic (id order, buckets, bucket-wide T_pad, chunk
    rows, the -inf fill beyond a chunk's k, trimming to true lengths)
    under one stubbed sample_batch: equal DatasetResults."""
    from bild_tpu.parallel import sharded as jsh
    datas = factorized_data() + [np.ones((3, 1)), np.ones((20, 1))]
    ids = np.array([40, 3, 17, 8, 25, 1, 9, 30])
    dists = [sp_stats.maxwell(scale=0.1), sp_stats.maxwell(scale=1)]
    monkeypatch.setattr(tsh, "sample_batch", stub_sample_batch)
    monkeypatch.setattr(jsh, "sample_batch", stub_sample_batch)
    kw = dict(k_max=4, N=8, bucket_edges=(4, 8, 16), chunk_size=3,
              informed_init=False, marginals=True)
    got = sample_dataset_sharded(
        bt.models.FactorizedModel(dists, d=1, **CPU),
        [bt.Trajectory.create(x, dtype=F64) for x in datas], ids,
        generator=gen(1), **kw)
    want = jsh.sample_dataset_sharded(
        bj.models.FactorizedModel(dists, d=1),
        [bj.Trajectory.create(x) for x in datas], ids, key=jax.random.key(1),
        **kw)
    assert np.isneginf(got.evidence).any()       # the fill is exercised
    assert_same(got, want)


def test_schedule_with_two_owners():
    """Hand-worked: chunk rows 0-1 belong to rank 0 and 2-3 to rank 1;
    trajectories 0-5 (ascending id) of lengths and owners below."""
    lengths = np.array([8, 8, 12, 8, 30, 8])
    owner = np.array([0, 1, 0, 0, 1, 0])
    row_owner = np.array([0, 0, 1, 1])
    work = tsh._schedule(lengths, owner, row_owner, 4, (10, 20))
    got = [(T, rows.tolist()) for T, rows in work]
    # bucket 10: rank 0 holds 0, 3, 5, rank 1 holds 1 -> two chunks;
    # bucket 20: only 2 (T_pad its length 12); 30 is oversize: its own
    assert got == [(8, [0, 3, 1, -1]), (8, [5, -1, -1, -1]),
                   (12, [2, -1, -1, -1]), (30, [-1, -1, 4, -1])]


def test_rank_without_rows_raises():
    """Fault (c): bild_tpu runs no chunk for a rank that owns trajectories
    but no row of the mesh and leaves them NaN; the port raises."""
    with pytest.raises(ValueError, match=r"ranks \[2\] own trajectories"):
        tsh._schedule(np.array([8, 8, 8]), np.array([0, 2, 1]),
                      np.array([0, 0, 1, 1]), 4, (10,))
