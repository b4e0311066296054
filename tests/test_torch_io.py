"""bild_tpu_torch.io (native and Python CSV loaders) against
bild_tpu.io.load_trajectories_csv_python on the same files, and
trajectory._from_dataframe against bild_tpu's."""
import numpy as np
import pandas as pd
import pytest
import torch

from bild_tpu import io as jio
from bild_tpu.trajectory import make_trajectory as j_make_trajectory
from bild_tpu_torch import io as tio
from bild_tpu_torch import native
from bild_tpu_torch.trajectory import make_trajectory
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

F64 = torch.float64
LOADERS = {"native": tio.load_trajectories_csv,
           "python": tio.load_trajectories_csv_python}


def write_table(path, two_locus=False):
    """Trajectory 7: frames 0..9 with a gap at 4; trajectory 3: frames
    2..6; rows shuffled, a header line."""
    rng = np.random.default_rng(3)
    width = 4 if two_locus else 2
    lines = ["id,frame," + ",".join(f"v{i}" for i in range(width))]
    rows = [(7, t) for t in range(10) if t != 4] + [(3, t) for t in range(2, 7)]
    rng.shuffle(rows)
    for tid, frame in rows:
        vals = rng.normal(size=width)
        lines.append(f"{tid},{frame}," + ",".join(f"{v:.6f}" for v in vals))
    path.write_text("\n".join(lines) + "\n")


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.data.dtype == F64 and g.data.device.type == "cpu"
        np.testing.assert_array_equal(g.valid.numpy(), np.asarray(w.valid))
        np.testing.assert_allclose(g.data.numpy(), np.asarray(w.data),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(g.localization_error, w.localization_error)


@pytest.mark.parametrize("loader", sorted(LOADERS))
@pytest.mark.parametrize("two_locus", [False, True])
def test_loaders_match_bild_tpu(tmp_path, loader, two_locus):
    if loader == "native" and native.get_lib() is None:
        pytest.skip("g++ unavailable: no native loader")
    p = tmp_path / "d.csv"
    write_table(p, two_locus)
    kw = dict(two_locus=two_locus, localization_error=0.2, return_ids=True)
    got, ids = LOADERS[loader](p, **kw, dtype=F64)
    want, want_ids = jio.load_trajectories_csv_python(p, **kw)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(ids, [3, 7])
    assert_same(got, want)
    assert [len(t) for t in got] == [5, 10]
    assert not bool(got[1].valid[4])              # the gap: a missing frame
    assert got[0].d == 2


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_ragged_first_row_and_max_frames(tmp_path, loader):
    p = tmp_path / "ragged.csv"
    p.write_text("0,0,1.5\n0,1,2.5,7.0,9.0\n0,2,3.5,8.0,10.0\n")
    got = LOADERS[loader](p, dtype=F64)
    assert_same(got, jio.load_trajectories_csv_python(p))
    assert got[0].d == 3 and np.all(np.isnan(got[0][:][0]))
    with pytest.raises(ValueError, match="max_frames"):
        LOADERS[loader](p, max_frames=2)
    assert got[0].data.dtype == F64
    assert LOADERS[loader](p)[0].data.dtype == torch.float32


def test_native_equals_python_on_a_large_table(tmp_path):
    if native.get_lib() is None:
        pytest.skip("g++ unavailable: no native loader")
    rng = np.random.default_rng(0)
    lines = [f"{i}\t{t}\t{x!r}\t{y!r}\t{z!r}"
             for i in range(150) for t in range(40) if rng.random() > 0.05
             for x, y, z in [rng.normal(size=3)]]
    rng.shuffle(lines)
    p = tmp_path / "big.tsv"
    p.write_text("\n".join(lines) + "\n")
    before = tio.load_trajectories_csv.native_parses
    a = tio.load_trajectories_csv(p, dtype=F64)
    assert tio.load_trajectories_csv.native_parses == before + 1
    b = tio.load_trajectories_csv_python(p, dtype=F64)
    assert len(a) == 150
    for ta, tb in zip(a, b):
        assert torch.equal(ta.valid, tb.valid)
        assert torch.equal(ta.data, tb.data)


def test_from_dataframe_matches_bild_tpu():
    rng = np.random.default_rng(1)
    cols = {c: rng.normal(size=6) for c in ("x1", "y1", "z1", "x2", "y2", "z2")}
    frames = np.array([3, 4, 5, 7, 8, 9])                  # frame 6 missing
    df = pd.DataFrame({"frame": frames, **cols, "note": list("abcdef")})
    got = make_trajectory(df, localization_error=0.1, dtype=F64)
    want = j_make_trajectory(df, localization_error=0.1)
    assert len(got) == 7 and not bool(got.valid[3])
    np.testing.assert_allclose(got[:], want[:], rtol=0, atol=1e-15)
    single = pd.DataFrame({"x": cols["x1"], "y": cols["y1"]})
    np.testing.assert_allclose(make_trajectory(single, dtype=F64)[:],
                               j_make_trajectory(single)[:], rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="coordinate columns"):
        make_trajectory(pd.DataFrame({"a": [1.0]}))
