"""Find a cell's parts by the names that ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its ``configs`` entry; the
traffic mix is ``traffic/<traffic>.json``, which names its loop
(``loops/<loop>.py``) and its scene recipe (``scenes/<scene>.py``); the
cell's limits for the comparison with the reference are
``checks/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell, a configuration or a metric is
adding files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]     # perfbench/
ROOT = BENCH_DIR.parent                              # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path = BENCH_DIR


def load_bench(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing {path}")
    return json.loads(path.read_text())


def _listed(metric: dict, cell: str, reported: set) -> bool:
    """A metric belongs to a cell that its ``workloads`` lists or, without
    the key, to every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def cell(bench: dict, name: str, root: Path = ROOT,
         bench_dir: Path = BENCH_DIR) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name, reported)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(Path(root) / conf["file"]),
                traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
                checks=_json(bench_dir / "checks" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """``<kind>/<name>.py`` under perfbench/, imported from its file."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"missing {path}")
    mod_name = f"perfbench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
