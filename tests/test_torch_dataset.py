"""bild_tpu_torch.parallel.sample_dataset end to end against
bild_tpu.parallel.sample_dataset on shared ragged trajectories made by
bild_tpu (float64): buckets and chunks, results in the original order at
true lengths, postproc, marginals and chunk-checkpoint resume."""
import os

import jax
import numpy as np
import pytest
import torch

import bild_tpu as bj
import bild_tpu_torch as bt
from bild_tpu.parallel import sample_dataset as j_sample_dataset
from bild_tpu_torch.parallel import dataset as tds
from bild_tpu_torch.parallel import sample_dataset
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
# two chunks of two, each with a full-length trajectory: one shape for
# bild_tpu's compiled programs
LENGTHS = (36, 28, 36, 30)
KW = dict(k_max=3, steps_per_k=6, N=40, scout_steps=2, refine_top=2,
          marginals=True, optimize_boundaries=True, chunk_size=2,
          bucket_edges=(40,))


@pytest.fixture(scope="module")
def shared():
    kw = dict(N=8, D=1.0, k=5.0, d=3, localization_error=0.1)
    jm = bj.models.MultiStateRouse(**kw)
    tm = bt.models.MultiStateRouse(**kw, device="cpu", dtype=F64)
    full = np.zeros((len(LENGTHS), 36), dtype=int)
    for i, T in enumerate(LENGTHS):
        full[i, T // 3: T // 3 + 10 + i] = 1
    batch = jm.trajectories_from_loopingprofiles(full, key=jax.random.key(10))
    profs = [full[i, :T] for i, T in enumerate(LENGTHS)]
    datas = [np.array(batch.data[i, :T]) for i, T in enumerate(LENGTHS)]
    datas[1][[0, 5]] = np.nan                    # missing frames
    jtrajs = [bj.Trajectory.create(x) for x in datas]
    ttrajs = [bt.Trajectory.create(x, dtype=F64) for x in datas]
    return jm, tm, profs, jtrajs, ttrajs


@pytest.fixture(scope="module")
def result(shared, tmp_path_factory):
    _, tm, _, _, ttrajs = shared
    ck = str(tmp_path_factory.mktemp("chunks"))
    res = sample_dataset(tm, ttrajs, **KW, checkpoint_dir=ck,
                         generator=torch.Generator().manual_seed(2))
    return res, ck


def test_matches_bild_tpu(shared, result):
    jm, _, profs, jtrajs, _ = shared
    rt, _ = result
    rj = j_sample_dataset(jm, jtrajs, **KW, key=jax.random.key(2))
    np.testing.assert_array_equal(rt.best_k(dE=2), rj.best_k(dE=2))
    np.testing.assert_array_equal(rt.best_k(dE=2), 2)
    assert not rt.eliminated.any()
    for res in (rj, rt):
        assert [len(p) for p in res.best_profile()] == list(LENGTHS)
        acc = np.mean(np.concatenate(res.best_profile(dE=2)) == np.concatenate(profs))
        assert acc >= 0.95
        acc_opt = np.mean(np.concatenate(res.optimized) == np.concatenate(profs))
        assert acc_opt >= 0.9
        assert res.mom_ok.shape == (4, 4) and res.mom_ok.all()
        assert res.eliminated.shape == (4,)
    assert all(m.shape == (4, 2, T) for m, T in zip(rt.marginals, LENGTHS))
    for post in rt.log_marginal_posterior(dE="average"):
        np.testing.assert_allclose(np.exp(post).sum(0), 1.0, rtol=1e-10)
    assert np.isfinite(rt.evidence).all()


def test_chunk_checkpoints_resume(shared, result, monkeypatch):
    _, tm, _, _, ttrajs = shared
    first, ck = result
    assert len([f for f in os.listdir(ck) if f.endswith(".npz")]) == 2

    def no_run(*a, **k):
        raise AssertionError("a chunk was recomputed")

    monkeypatch.setattr(tds, "sample_batch", no_run)
    again = sample_dataset(tm, ttrajs, **KW, checkpoint_dir=ck,
                           generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(again.evidence, first.evidence)
    for a, b in zip(again.optimized + again.marginals + again.profiles_by_k,
                    first.optimized + first.marginals + first.profiles_by_k):
        np.testing.assert_array_equal(a, b)
    # another seed keys other chunk files
    with pytest.raises(AssertionError, match="recomputed"):
        sample_dataset(tm, ttrajs, **KW, checkpoint_dir=ck,
                       generator=torch.Generator().manual_seed(3))


def test_buckets_and_original_order(shared, result, tmp_path):
    """Other buckets regroup the trajectories into other chunks; results
    still come back in the original order at true lengths."""
    _, tm, profs, _, ttrajs = shared
    first, _ = result
    kw = {**KW, "bucket_edges": (29, 40), "chunk_size": 2, "marginals": False}
    res = sample_dataset(tm, ttrajs, **kw, checkpoint_dir=str(tmp_path),
                         generator=torch.Generator().manual_seed(2))
    # buckets: 29 holds [1], 40 holds [0, 2, 3]: chunks [1], [0, 2], [3]
    assert len(os.listdir(tmp_path)) == 3
    assert [p.shape for p in res.profiles_by_k] == [(4, T) for T in LENGTHS]
    assert [len(p) for p in res.optimized] == list(LENGTHS)
    np.testing.assert_array_equal(res.best_k(dE=2), first.best_k(dE=2))
    acc = np.mean(np.concatenate(res.best_profile(dE=2)) == np.concatenate(profs))
    assert acc >= 0.95 and res.marginals is None


def test_unported_options_raise(shared):
    """What `bild_tpu` refuses too: the adaptive schedule on a mesh, an
    ensemble through a dataset run, an unknown schedule."""
    from bild_tpu_torch.parallel import make_mesh
    _, tm, _, _, ttrajs = shared
    with pytest.raises(ValueError, match="mesh"):
        sample_dataset(tm, ttrajs, schedule="adaptive",
                       mesh=make_mesh(devices="cpu"))
    with pytest.raises(ValueError, match="ensemble"):
        sample_dataset(tm, ttrajs, ensemble=4)
    with pytest.raises(ValueError, match="schedule"):
        sample_dataset(tm, ttrajs, schedule="other")


def test_trajectories_move_to_the_model(shared):
    """float32 trajectories on the CPU (`Trajectory.create`'s default, what
    the CSV loader makes) into a float64 model give the bits of float64
    trajectories holding the same values, through sample_batch and
    sample_dataset."""
    _, tm, _, _, ttrajs = shared
    f32 = [bt.Trajectory.create(t[:]) for t in ttrajs]
    f64 = [bt.Trajectory.create(t[:].astype(np.float32).astype(np.float64),
                                dtype=F64) for t in ttrajs]
    assert f32[0].data.dtype == torch.float32
    kw = dict(k_max=2, steps_per_k=3, N=16, informed_init=True)
    a, b = (bt.parallel.sample_batch(tm, bt.parallel.stack_trajectories(t),
                                     **kw, generator=torch.Generator().manual_seed(4))
            for t in (f32, f64))
    np.testing.assert_array_equal(a.evidence, b.evidence)
    np.testing.assert_array_equal(a.map_profiles, b.map_profiles)
    a, b = (sample_dataset(tm, t, **kw, chunk_size=2, bucket_edges=(40,),
                           generator=torch.Generator().manual_seed(4))
            for t in (f32, f64))
    np.testing.assert_array_equal(a.evidence, b.evidence)
    for x, y in zip(a.profiles_by_k, b.profiles_by_k):
        np.testing.assert_array_equal(x, y)
