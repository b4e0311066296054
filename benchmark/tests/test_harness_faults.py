"""A run with the timed path broken underneath comes out not correct: for
each cell, on the CPU at a tiny size, with each fault the cell can have
planted in the program (`benchmark.faults`)."""
import json

import pytest

from bild_tpu_torch import postproc
from bild_tpu_torch.models.msrouse import MultiStateRouse
from bild_tpu_torch.parallel import batch
from benchmark import faults, harness
from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(small_checkout, cell, fault):
    with faults.plant(fault):
        code, res = harness.run(cell, 2**31 + 11, 1.0, False, root=small_checkout,
                                device="cpu")
    assert code == 0
    assert res["correct"] is False, res["checks"]


def test_planting_is_undone():
    before = (MultiStateRouse.lockstep_fns, batch.lane_step, postproc.optimize_boundary_batch,
              batch._marginal_posterior)
    for fault in faults.FAULTS:
        with faults.plant(fault):
            pass
    assert before == (MultiStateRouse.lockstep_fns, batch.lane_step,
                      postproc.optimize_boundary_batch, batch._marginal_posterior)
