"""bild_tpu_torch.utils.profiling: `trace` writes a Chrome trace of the
block, the port's spans among its ranges; `strict_numerics` raises where
a backward pass makes NaN."""
import json

import numpy as np
import pytest
import torch

import bild_tpu_torch as bt
from bild_tpu_torch.utils import strict_numerics, trace
import test_torch_kalman  # noqa: F401  (one torch thread per worker)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).cumsum(0).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::cumsum" in names
    with open(tmp_path / "prof" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::cumsum" for e in events)


def test_trace_shows_the_sample_span(tmp_path):
    model = bt.models.MultiStateRouse(8, 1.0, 5.0, d=3, localization_error=0.1,
                                      device="cpu", dtype=torch.float64)
    profile = np.zeros(20, dtype=int)
    profile[6:14] = 1
    traj = model.trajectory_from_loopingprofile(profile,
                                                generator=torch.Generator().manual_seed(1))
    with trace(str(tmp_path / "prof")):
        bt.sample(traj, model, k_max=2, init_runs=2,
                  generator=torch.Generator().manual_seed(2))
    with open(tmp_path / "prof" / "trace.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"sample", "sample.decide", "sampler.init"} <= names


def test_strict_numerics_raises_on_backward_nan():
    def objective(x):
        return torch.sqrt(x - 1.0).sum()      # d/dx at x = 1: inf * 0 below

    x = torch.ones(3, dtype=torch.float64, requires_grad=True)
    (objective(x) * 0.0).backward()           # NaN gradient, silently
    assert torch.isnan(x.grad).all()
    x.grad = None
    with strict_numerics():
        with pytest.raises(RuntimeError, match="nan"):
            (objective(x) * 0.0).backward()
    with strict_numerics(nans=False):
        (objective(x) * 0.0).backward()       # off: as before
    assert not torch.is_anomaly_enabled()
