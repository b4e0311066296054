"""bild_tpu_torch.parallel.mesh in one process: one-rank meshes, the shape
rules, the ``time`` mesh, `shard_batch`'s blocks against bild_tpu's on the 8-device CPU JAX
mesh (tests/conftest.py), the single-rank identities, and the byte
transport of `fetch_to_host` through a real one-rank gloo group. The
two-process runs are in tests/test_torch_distributed.py."""
import datetime
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
from scipy import stats as sp_stats

from bild_tpu.parallel import make_mesh as j_make_mesh
from bild_tpu.parallel import shard_batch as j_shard_batch
import bild_tpu_torch as bt
from bild_tpu_torch.parallel import mesh as tmesh
from bild_tpu_torch.parallel import (broadcast_from_process0, fetch_to_host,
                                     is_multiprocess, make_mesh, sample_batch,
                                     sample_dataset, sample_dataset_sharded,
                                     shard_batch, stack_trajectories)
import test_torch_kalman  # noqa: F401  (one torch thread per worker)


def test_one_rank_mesh():
    mesh = make_mesh(devices="cpu")
    assert mesh.shape == {"data": 1, "prof": 1} and mesh.ranks == (0,)
    assert mesh.index == 0 and mesh.device.type == "cpu"
    assert not is_multiprocess(mesh) and mesh.group is None
    assert make_mesh(axis_names=("data",), devices="cpu").shape == {"data": 1}
    # bild_tpu's default mesh names the same two axes
    assert tuple(j_make_mesh().axis_names) == tuple(mesh.shape)


def test_shape_rules(monkeypatch):
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh((2, 1), devices="cpu")
    for shape in ((2, 2), (1, 2)):        # nothing shards over 'prof'
        with pytest.raises(ValueError, match="'prof'"):
            make_mesh(shape, devices="cpu")
    with pytest.raises(ValueError, match="'data' axis"):
        make_mesh((1,), axis_names=("batch",), devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()                       # the GPU by default, never the CPU


def test_time_mesh():
    """A mesh whose sharded axis is ``time`` (bild_tpu's
    ``make_mesh((8,), axis_names=("time",))``, for logL_batch_assoc); the
    dataset runners refuse it."""
    mesh = make_mesh((1,), axis_names=("time",), devices="cpu")
    assert mesh.shape == {"time": 1} and mesh.ranks == (0,)
    assert mesh.index == 0 and mesh.group is None and not is_multiprocess(mesh)
    assert tuple(j_make_mesh((8,), axis_names=("time",)).axis_names) == ("time",)
    with pytest.raises(ValueError, match="'prof'"):
        make_mesh((1, 2), axis_names=("time", "prof"), devices="cpu")
    with pytest.raises(ValueError, match="only the 'data' axis"):
        make_mesh((1, 2), axis_names=("data", "time"), devices="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh((2,), axis_names=("time",), devices="cpu")

    model = bt.models.FactorizedModel([sp_stats.maxwell(scale=0.1),
                                       sp_stats.maxwell(scale=1)], d=1,
                                      device="cpu", dtype=torch.float64)
    trajs = [bt.Trajectory.create(np.random.default_rng(0).normal(size=8),
                                  dtype=torch.float64)]
    kw = dict(k_max=1, steps_per_k=2, N=8, mesh=mesh)
    for run in (lambda: sample_batch(model, stack_trajectories(trajs), **kw),
                lambda: sample_dataset(model, trajs, **kw),
                lambda: sample_dataset_sharded(model, trajs, [0], **kw)):
        with pytest.raises(ValueError, match="need a mesh with a 'data' axis"):
            run()


def test_shard_batch_blocks_match_bild_tpu():
    jmesh = j_make_mesh(axis_names=("data",))
    D = jmesh.shape["data"]
    assert D == 8
    tree = (np.arange(16 * 3, dtype=np.float64).reshape(16, 3),
            np.arange(16) % 3 == 0, np.float64(2.5))
    jtree = j_shard_batch(tree, jmesh)
    n = 16 // D

    def blocks(jarr):
        return {(s.index[0].start or 0) // n: np.asarray(s.data)
                for s in jarr.addressable_shards}

    b0, b1 = blocks(jtree[0]), blocks(jtree[1])
    assert sorted(b0) == sorted(b1) == list(range(D))
    for r in range(D):
        mesh = tmesh.Mesh({"data": D}, tuple(range(D)), r, torch.device("cpu"))
        got = shard_batch(tree, mesh)
        np.testing.assert_array_equal(got[0], b0[r])
        np.testing.assert_array_equal(got[1], b1[r])
        assert got[2] == 2.5
        t = shard_batch(torch.as_tensor(tree[0]), mesh)
        np.testing.assert_array_equal(t.numpy(), b0[r])
    odd = np.zeros((12, 2))
    with pytest.raises(ValueError, match="not divisible by mesh axis 'data'") as want:
        j_shard_batch(odd, jmesh)
    with pytest.raises(ValueError, match="not divisible by mesh axis 'data'") as got:
        shard_batch(odd, tmesh.Mesh({"data": 8}, tuple(range(8)), 0,
                                    torch.device("cpu")))
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_single_rank_identities():
    mesh = make_mesh(devices="cpu")
    x = np.array([[1.0, -np.inf], [np.nan, 2.0]])
    tree = {"a": x, "b": (torch.arange(3), np.array([True, False]))}
    got = fetch_to_host(tree, mesh)
    np.testing.assert_array_equal(got["a"], x)
    np.testing.assert_array_equal(got["b"][0], np.arange(3))
    assert isinstance(got["b"][0], np.ndarray)
    assert broadcast_from_process0(tree) is tree
    assert broadcast_from_process0(tree, mesh) is tree
    assert tmesh.feed_process_local(x, mesh, global_batch=2).dtype == torch.float64
    with pytest.raises(ValueError, match="share"):
        tmesh.feed_process_local(x, mesh, global_batch=3)


def test_one_rank_gloo_world_moves_bits():
    """The collective behind `fetch_to_host` (rows packed as bytes, one
    all-gather, unpacked) in a real one-rank gloo world, initialized and
    destroyed here: float64 with -inf and NaN, int32, bool and an empty
    column pass bit for bit."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mesh = make_mesh(axis_names=("data",), devices="cpu", distributed=True,
                     coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                     process_id=0, timeout=datetime.timedelta(seconds=60))
    try:
        assert mesh.backend == "gloo" and mesh.shape == {"data": 1}
        x = np.array([[np.nan, -np.inf, np.inf], [-0.0, 1e-310, 3.0]])
        x[0, 0] = np.frombuffer(np.uint64(0x7FF8DEADBEEF0001).tobytes(),
                                np.float64)[0]       # a NaN with a payload
        leaves = [x, np.array([7, -8], np.int32), np.array([True, False]),
                  np.zeros((2, 0))]
        got = tmesh._all_gather_rows(leaves, mesh)
        for a, b in zip(got, leaves):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        assert broadcast_from_process0(np.int64(5), mesh) == 5
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()

