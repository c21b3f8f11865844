"""Every part of a cell is found by the name BENCHMARK.json gives it, and a
cell added as files alone is listed and runs."""

import json
import shutil

import pytest

from harness import registry, runner
from tiny import tiny_cell

BENCH = registry.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_benchmark_json_keys():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = registry.cell(BENCH, name)
    tr = cell.traffic
    assert registry.load_module("loops", tr["loop"]).Loop
    assert registry.load_module("scenes", tr["scene"]).build
    assert cell.config["reduced"] == []
    assert set(cell.checks) == {"first_gap", "out_gap", "last_gap",
                                "failed"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(registry.load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    conf = registry._json(registry.ROOT / entry["file"])
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert conf["device"]["sample_type"] == "float32"


def test_cell_added_as_files(tmp_path):
    """A copy of the benchmark's data with one more cell: a traffic file,
    a checks file and a BENCHMARK.json entry, and nothing else."""
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(registry.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = json.loads((bench_dir / "traffic" / "batch_native.json")
                         .read_text())
    traffic["scene_params"].update(tones=5, tone_seconds=0.25,
                                   position_sigma=1.5)
    traffic["loop_params"]["call_blocks"] = 8
    (bench_dir / "traffic" / "dummy_short.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench_dir / "checks" / "hrtf4096.best_case.json",
                bench_dir / "checks" / "hrtf4096.dummy.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "hrtf4096.dummy",
                               "config": "hrtf_stereo_4096",
                               "traffic": "dummy_short", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "realtime_x" in (m["name"], m.get("moves")):
            m.setdefault("workloads", []).append("hrtf4096.dummy")
    cell = tiny_cell("hrtf4096.dummy", bench, bench_dir=bench_dir)
    assert [m["name"] for m in cell.end_to_end] == ["realtime_x", "setup_s"]
    res = runner.run_cell(cell, 2**31 + 7, 0.2, False, device="cpu")
    assert res["correct"], res["checks"]
    assert res["metrics"]["realtime_x"]["value"] > 0
