"""Model kinds (``benchmark/models/<model>.py``): the Rouse kind draws and
judges exactly what the generator and the reference do by themselves, a
kind is added by files alone, and a configuration whose ``model`` names no
file fails by naming it."""
import json
import shutil

import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from benchmark import harness
from benchmark.reference import kalman, rouse
from benchmark.traffic import generate
from conftest import ROOT

CONFIGS = ["rouse2-readme", "rouse3-config4"]


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_the_rouse_kind_is_the_generator_and_the_reference(name):
    cfg = config(name)
    kind = harness.model_kind(ROOT, cfg)(bt, cfg, torch.device("cpu"))
    loops = [None if x is None else tuple(x) for x in cfg["looppositions"]]
    arrays = rouse.operators(cfg["N"], cfg["D"], cfg["k"], cfg["d"], cfg["dt"], loops)
    seed = 2**31 + 99
    truths = generate.truths(generate.substream(seed, "t"), 24, 30, kind.n_states, 4, "cpu")
    data = kind.trajectories(generate.substream(seed, "d"), truths)
    want = generate.trajectories(generate.substream(seed, "d"), truths, arrays,
                                 cfg["localization_error"], "cpu")
    assert data.dtype == torch.float32 and torch.equal(data, want)
    assert kind.n_states == len(loops) and kind.d == cfg["d"] == data.shape[-1]
    assert kind.sizes == {"n": len(loops), "N": cfg["N"], "d": cfg["d"], "q": 1}
    assert all(np.array_equal(kind.arrays[k], arrays[k]) for k in arrays)

    ops = kalman.Operators(arrays, np.full(cfg["d"], cfg["localization_error"]), "cpu")
    profiles = truths.numpy()[:12]
    x = data.double().numpy()
    assert np.array_equal(kind.reference.logL(profiles, x[0]), kalman.logL(ops, profiles, x[0]))
    rows = np.arange(12) % 5
    assert np.array_equal(kind.reference.logL(profiles, x[:5], rows=rows),
                          kalman.logL(ops, profiles, x[:5], rows=rows))

    traj = kind.trajectory(data[3])
    assert isinstance(traj, bt.Trajectory) and torch.equal(traj.data, data[3])
    assert bool(traj.valid.all()) and traj.valid.shape == (30,)
    assert np.array_equal(traj.localization_error, np.full(cfg["d"], cfg["localization_error"]))


def test_a_kind_is_added_by_files_alone(small_checkout):
    """A copy of the Rouse kind under another name, a configuration that
    names it and a cell: the same readings as the Rouse cell on the same
    seed (one call each)."""
    bench = small_checkout / "benchmark"
    shutil.copy(bench / "models" / "MultiStateRouse.py", bench / "models" / "RouseCopy.py")
    cfg = json.loads((bench / "configs" / "rouse2-readme.json").read_text())
    cfg.update(name="rouse2-copy", model="RouseCopy")
    (bench / "configs" / "rouse2-copy.json").write_text(json.dumps(cfg))
    spec = json.loads((small_checkout / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "rouse2-copy", "source": "a test",
                            "file": "benchmark/configs/rouse2-copy.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "rouse2-copy-lockstep", "config": "rouse2-copy",
                              "traffic": "lockstep-T100-1024", "chips": 1, "why": "a test"})
    (small_checkout / "BENCHMARK.json").write_text(json.dumps(spec))
    runs = [harness.run(cell, 2**31 + 21, 1e-6, False, root=small_checkout, device="cpu",
                        readings=True)
            for cell in ("rouse2-lockstep-T100", "rouse2-copy-lockstep")]
    (code, rouse_res), (copy_code, copy_res) = runs
    assert code == copy_code == 0
    assert rouse_res["window"]["calls"] == copy_res["window"]["calls"] == 1
    assert copy_res["readings"] == rouse_res["readings"]
    assert copy_res["checks"] == rouse_res["checks"] and copy_res["correct"] is True


def test_a_model_without_a_kind_file_is_named(small_checkout):
    path = small_checkout / "benchmark" / "configs" / "rouse2-readme.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "model": "NoSuchModel"}))
    with pytest.raises(SystemExit, match=r"benchmark/models/NoSuchModel\.py"):
        harness.run("rouse2-sample-T100", 3, 1.0, False, root=small_checkout, device="cpu")
