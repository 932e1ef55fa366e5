"""The control of each cell's check, on the card: the plain reference one
step below the configurations' precision (sums in float32, products in
TF32), put in the program's place, comes out not correct, while the
program's own readings of the same run stay within the limits. At a size
a test run holds (the cells' traffic shortened; the cells' own size is
what ``portbench/control.py`` reads on the card). Run on the card:

    python -m pytest -m cuda portbench/tests/test_portbench_control_cuda.py
"""

import pytest
import torch

from portbench import control, harness

SEED = 2**31 + 104729


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")


def _short(name, **params):
    cell = harness.load_cell(name)
    cell["params"].update(params)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name, params", [
    ("vo.fleet8", {"check_calls": 1}),
    ("slam.desk16", {"frames": 160, "check_frames": 160}),
])
def test_the_control_is_not_correct_and_the_program_is(card, name, params):
    cell = _short(name, **params)
    out = control.readings(cell, SEED, 1.0)
    limits = cell["limits"]
    assert all(out["program"][k] <= limits[k] for k in limits), out
    assert any(out["control"][k] > limits[k] for k in limits), out
