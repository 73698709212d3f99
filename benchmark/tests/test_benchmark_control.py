"""The check's control on the card: the plain reference in TF32, put in
the program's place, at each cell's own size, reads above the cell's
limits (TF32 exists on the card only)."""

import pytest

from benchmark import check, control, harness

CELLS = ["deferred_1080p.orbit", "stress_1440p.drag", "stress_1440p.orbit",
         "deferred_1080p.drag"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cuda_device, cell):
    man = harness._load_json(f"{harness.ROOT}/BENCHMARK.json")
    if cell not in {w["name"] for w in man["workloads"]}:
        pytest.skip(f"{cell} is not in the manifest")
    limits = harness.resolve(man, cell).limits
    numbers = control.readings(cell, 31337, device=cuda_device)
    assert not check.passed(check.judge(numbers, limits))
    over = [k for k in check.NUMBERS if numbers[k] > limits[k]]
    assert over == list(check.NUMBERS), (numbers, limits)
