"""Each cell at a tiny size on the CPU: the scene recipe through the port's
al.api, the loop, and the comparison with the independent reference."""

import numpy as np
import pytest

from harness import registry, runner
from tiny import VOICES, tiny_cell

CELLS = [w["name"] for w in registry.load_bench()["workloads"]]
GAPS = ("first_gap", "out_gap", "last_gap")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_agrees(name, trace):
    cell = tiny_cell(name)
    res = runner.run_cell(cell, 2**31 + 1001, 0.2, bool(trace), device="cpu")
    assert res["correct"], res["checks"]
    values = {k: c["value"] for k, c in res["checks"].items()}
    assert set(values) == set(GAPS) | {"failed"} and values["failed"] == 0
    # Two float32 renders of the same sum: round-off, not zero, not more.
    assert all(0.0 < values[g] < 1e-6 for g in GAPS), values
    assert list(res)[-2:] == ["checks", "notes"]
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_same_seed_same_scene():
    cell = tiny_cell(CELLS[0])
    a, b = (runner.scene_inputs(cell, 99) for _ in range(2))
    c = runner.scene_inputs(cell, 100)
    assert np.array_equal(a["positions"], b["positions"])
    assert not np.array_equal(a["positions"], c["positions"])
    assert len(a["voice_tone"]) == VOICES
    assert runner.compared_calls(cell, 2**33 + 1) == \
        runner.compared_calls(cell, 2**33 + 1)


def test_large_seeds_are_taken():
    cell = tiny_cell(CELLS[0])
    for seed in (0, 2**31 - 1, 2**31 + 5, 2**40 + 3):
        assert runner.scene_inputs(cell, seed)["positions"].shape == (
            VOICES, 3)


def test_round_off_ties_follow_the_program():
    """At the cell's 4096 voices, seed 3100000025 puts six voice-ears
    within float32 round-off of a half-sample delay tie (the program rounds
    one of them the other way); the comparison lets each tie round either
    way and holds every other delay fixed."""
    cell = registry.cell(registry.load_bench(), CELLS[0])
    cell.traffic["loop_params"]["call_blocks"] = 2
    cell.traffic["compare_within"] = 2
    res = runner.run_cell(cell, 3100000025, 0.2, False, device="cpu")
    assert res["notes"]["round_off_ties"] == 6
    assert res["correct"], res["checks"]
    assert all(res["checks"][g]["value"] < 1e-6 for g in GAPS)
