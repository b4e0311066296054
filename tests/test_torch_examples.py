"""The port's examples (`bild_tpu_torch.examples`) end to end on the CPU at
their smoke sizes: the labelled lines that `tests/test_examples.py` asserts
for `bild_tpu`'s examples, and the dict each ``main`` returns; for the GGM
example also its data and per-frame guess against `bild_tpu`'s."""
import ast
import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.examples import (calibrate_params, ggm_model,
                                     infer_dataset, parse_args, setup,
                                     single_trajectory)
import test_torch_kalman  # noqa: F401  (one torch thread per worker)

EXAMPLES = os.path.join(os.path.dirname(bt.__file__), "examples")


def test_single_trajectory(capsys):
    out = single_trajectory.main(device="cpu", smoke=True)
    text = capsys.readouterr().out
    assert "best k:" in text and "frame accuracy:" in text
    assert set(out) == {"evidence", "best_k", "frame_accuracy",
                        "inferred_accuracy"}
    assert np.all(np.isfinite(out["evidence"]))
    assert out["best_k"] == int(np.argmax(out["evidence"]))
    assert 0.0 <= out["frame_accuracy"] <= 1.0


def test_infer_dataset_synthesized(capsys):
    out = infer_dataset.main(device="cpu", smoke=True)
    text = capsys.readouterr().out
    assert "k histogram" in text and "synthesized 6 trajectories" in text
    assert out["n_trajectories"] == 6 and out["k_histogram"].sum() == 6
    assert out["best_k"].shape == (6,)
    assert 0.0 <= out["frame_accuracy"] <= 1.0
    assert 0.0 <= out["switch_count_accuracy"] <= 1.0


def test_infer_dataset_from_csv(tmp_path, capsys):
    """Three two-locus trajectories of different lengths from a CSV."""
    model = bt.models.MultiStateRouse(8, 1, 5, d=3, localization_error=0.1,
                                      device="cpu", dtype=torch.float64)
    path = tmp_path / "tracks.csv"
    rng = np.random.default_rng(4)
    with open(path, "w") as f:
        f.write("traj_id,frame,x1,y1,z1,x2,y2,z2\n")
        for i, T in enumerate((24, 20, 24)):
            prof = np.zeros(T, dtype=int)
            prof[5:12] = i % 2
            rel = model.trajectory_from_loopingprofile(
                prof, generator=torch.Generator().manual_seed(i))[:]
            base = rng.normal(size=3)
            for t in range(T):
                vals = np.concatenate([base, base + rel[t]])
                f.write(f"{i},{t}," + ",".join(repr(float(v)) for v in vals)
                        + "\n")
    out = infer_dataset.main(str(path), device="cpu", smoke=True)
    text = capsys.readouterr().out
    assert f"loaded 3 trajectories from {path}" in text
    assert "k histogram" in text
    assert out["n_trajectories"] == 3 and out["k_histogram"].sum() == 3
    assert "frame_accuracy" not in out          # no truths for a file


def test_calibrate_params(capsys):
    out = calibrate_params.main(device="cpu", smoke=True)
    text = capsys.readouterr().out
    assert "frame accuracy with calibrated model:" in text
    assert set(out) == {"D", "k", "localization_error", "nll",
                        "frame_accuracy"}
    assert out["nll"][1] < out["nll"][0]
    # the start is 2x off; the fit moves towards D=1, k=5, err=0.1
    assert abs(np.log(out["D"])) < np.log(2)
    assert abs(np.log(out["k"] / 5)) < np.log(2)


def _bild_tpu_ggm_start(monkeypatch, capsys):
    """`bild_tpu`'s ``examples/ggm_model.py`` run in-process at its smoke
    size up to its first sampler call: the trajectories it drew and the
    per-frame guess accuracy it printed."""
    import bild_tpu
    from bild_tpu.models import GenericGaussianModel as JGGM

    drawn = []
    draw = JGGM.trajectory_from_loopingprofile
    monkeypatch.setattr(JGGM, "trajectory_from_loopingprofile",
                        lambda self, *a, **kw: drawn.append(
                            draw(self, *a, **kw)) or drawn[-1])
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("BILD_SMOKE", "1")
    spec = importlib.util.spec_from_file_location(
        "bild_tpu_ggm_example", os.path.join(
            os.path.dirname(bild_tpu.__file__), "..", "examples", "ggm_model.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(example, "bild", types.SimpleNamespace(sample=stop))
    with pytest.raises(Stop):
        example.main()
    text = capsys.readouterr().out
    guess = float(text.split("per-frame MLE guess accuracy:")[1].split()[0])
    return drawn, guess


def test_ggm_model(monkeypatch, capsys):
    """The labelled lines and the returned dict; the data and the per-frame
    guess (which draw nothing from torch) equal `bild_tpu`'s example's."""
    ref_trajs, ref_guess = _bild_tpu_ggm_start(monkeypatch, capsys)
    drawn = []
    draw = bt.models.GenericGaussianModel.trajectory_from_loopingprofile
    monkeypatch.setattr(bt.models.GenericGaussianModel,
                        "trajectory_from_loopingprofile",
                        lambda self, *a, **kw: drawn.append(
                            draw(self, *a, **kw)) or drawn[-1])
    out = ggm_model.main(device="cpu", smoke=True)
    text = capsys.readouterr().out
    assert len(drawn) == len(ref_trajs) == 3
    for got, ref in zip(drawn, ref_trajs):
        assert np.array_equal(got.data.numpy(), np.asarray(ref.data))
        assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert out["guess_accuracy"] == ref_guess
    assert "dataset: mean frame accuracy" in text
    assert "fitted MSD parameters" in text
    assert sum(out["k_histogram"]) == 3
    assert len(out["parameters"]) == 2
    assert all({"G", "J"} <= set(p) for p in out["parameters"])
    assert 0.0 <= out["dataset_accuracy"] <= 1.0


def test_setup_and_command_line(monkeypatch):
    monkeypatch.setenv("BILD_SMOKE", "1")
    assert setup("cpu", None) == (torch.device("cpu"), torch.float64, True)
    assert setup("cpu", False)[2] is False
    args = parse_args("x", ["tracks.csv", "--device", "cpu", "--smoke"],
                      csv=True)
    assert (args.csv, args.device, args.smoke) == ("tracks.csv", "cpu", True)
    args = parse_args("x", [])
    assert args.device is None and args.smoke is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup(None, True)                # the card, or an error


def test_examples_import_no_jax():
    """The examples, like the rest of the port, import neither JAX nor
    `bild_tpu`."""
    names = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert names == ["__init__.py", "calibrate_params.py", "ggm_model.py",
                     "infer_dataset.py", "single_trajectory.py"]
    for name in names:
        with open(os.path.join(EXAMPLES, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                root = mod.split(".")[0]
                assert root not in ("jax", "jaxlib", "bild_tpu"), (name, mod)
