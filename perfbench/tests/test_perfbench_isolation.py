"""What the benchmark loads, and how it fails without a card or without
the program: each in a fresh interpreter."""

import json
import os
import shutil
import subprocess
import sys

from harness import registry

ROOT = registry.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "openal_soft_tpu"}

RUN_TINY = """
import json, sys
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
from harness import registry, runner
from tiny import tiny_cell
import importlib.util
for kind in ("loops", "scenes", "metrics"):
    for f in (registry.BENCH_DIR / kind).glob("*.py"):
        registry.load_module(kind, f.stem)
res = runner.run_cell(tiny_cell("hrtf4096.best_case"), 3, 0.2, False,
                      device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def fresh(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_not_the_jax_package():
    top = set(fresh(RUN_TINY.format(bench=str(registry.BENCH_DIR),
                                    tests=str(registry.BENCH_DIR / "tests"),
                                    root=str(ROOT))))
    assert "openal_soft_tpu_torch" in top        # the program ran
    assert not top & FORBIDDEN                   # compared as whole names


def test_the_reference_loads_nothing_of_the_program():
    top = set(fresh(f"""
import json, sys
import numpy as np
sys.path[:0] = [{str(registry.BENCH_DIR)!r}]
from reference import binaural, mhr
hset = mhr.load({str(registry.BENCH_DIR / "data" / "default_hrtf.mhr")!r})
ref = binaural.Binaural(hset, [np.ones(100, np.float32)], [0],
                        np.array([[1.0, 2.0, 3.0]]), 48000)
assert ref.render(0, 256).shape == (256, 2)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""))
    assert "reference" in top
    assert not top & (FORBIDDEN | {"openal_soft_tpu_torch"})


def test_forbidden_names_compare_whole():
    from harness import runner

    sys.modules.setdefault("openal_soft_tpu_torch_lookalike", sys)
    try:
        assert "openal_soft_tpu" not in runner.forbidden_modules()
    finally:
        del sys.modules["openal_soft_tpu_torch_lookalike"]


def _run(cwd, env=None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "hrtf4096.best_case", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=600, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, env)
    assert res.returncode == 3, res.stderr[-2000:]
    assert res.stdout.strip() == ""
    assert "no card" in res.stderr


def test_benchmark_alone_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and perfbench/."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
