"""On the card, at each cell's own size (skips without one): a sound run
is correct, and the control, the program's own W8A8 path (K3), is not."""

import time

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.Bench().spec["workloads"]]


def _run(workload, seed, device, control):
    return harness.run_cell(workload, seed, 2.0, False, t0=time.perf_counter(), device=device,
                            control=control, log=lambda line: None)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    result = _run(workload, 2 ** 31 + 17, card, control=False)
    assert result["device"]["platform"] == "gpu"
    assert result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload, seed):
    result = _run(workload, seed, card, control=True)
    assert not result["correct"], result["checks"]
