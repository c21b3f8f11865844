"""The control on the card: the reference in the program's place, in
float32 with TF32 on, comes out not correct, and the program comes out
correct.  At the cells' own sizes ``perfbench/control.py`` reads both; here
at a size a test run holds."""

import pytest

import control
from harness import registry, runner
from tiny import tiny_cell

CELLS = [w["name"] for w in registry.load_bench()["workloads"]]


def _cell(name):
    c = tiny_cell(name)
    c.config["device"]["capacity"] = c.traffic["scene_params"]["voices"] = 256
    c.traffic["loop_params"]["call_blocks"] = 16
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_is_not_correct(cell, card):
    res = control.control(_cell(cell), 2**31 + 5)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_on_the_card(cell, card):
    res = runner.run_cell(_cell(cell), 2**31 + 5, 0.5, False, device=card)
    assert res["correct"], res["checks"]
