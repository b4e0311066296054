"""A run with the timed path broken underneath comes out not correct: for
each cell, on the CPU at a tiny size, with each fault the cell can have
planted in the program (`benchmark.faults`)."""
import json

import pytest

from bild_tpu_torch import postproc
from bild_tpu_torch.models.base import MultiStateModel
from bild_tpu_torch.models.ggm import GenericGaussianModel
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


def planted():
    return (MultiStateRouse.lockstep_fns, MultiStateRouse.lockstep_fns_lane,
            GenericGaussianModel.lockstep_fns, MultiStateModel.lockstep_fns_lane,
            batch.lane_step, postproc.optimize_boundary_batch, batch._marginal_posterior)


def test_planting_is_undone():
    before = planted()
    for fault in faults.FAULTS:
        with faults.plant(fault):
            pass
    assert before == planted()


def test_the_likelihood_faults_reach_every_model_class():
    """Not only the Rouse model's closures: a model kind of another class
    is broken by the same faults."""
    before = planted()
    with faults.plant("half_the_batch"):
        during = planted()
    assert all(a is not b for a, b in zip(before[:4], during[:4]))
    with faults.plant("altered_answer"):
        during = planted()
    assert during[1] is not before[1] and during[3] is not before[3]
    assert during[0] is before[0] and during[2] is before[2]
