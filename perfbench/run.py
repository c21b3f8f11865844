#!/usr/bin/env python3
"""Run one cell of the benchmark of ``openal_soft_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Prints the
numbers compared with the reference, each beside its limit, as the last
lines of standard error, and one JSON object as the last line of standard
output.  Exits 3 without a result when the cell's cards are missing, and
non-zero without a result on any other failure.
"""

import time

T0 = time.perf_counter()          # set-up is timed from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every build and kernel cache at a fixed path inside the checkout.
CACHE = ROOT / ".perfbench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)
# One thread for the host's math libraries: the cells are bound by one
# Python thread that launches, and idle pools spinning beside it on the
# shared host widen the spread between runs.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path[:1] = [str(HERE), str(ROOT)]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them: the
    roofline shares hold only at the limit they were read under."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import registry, runner

    spec = importlib.util.find_spec("openal_soft_tpu_torch")
    if spec is None or ROOT not in Path(spec.origin).resolve().parents:
        print(f"openal_soft_tpu_torch is not in the checkout {ROOT}",
              file=sys.stderr)
        return 2
    try:
        cell = registry.cell(registry.load_bench(ROOT), args.workload)
    except (FileNotFoundError, KeyError) as exc:
        print(exc, file=sys.stderr)
        return 2
    try:
        res = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t0=T0)
    except runner.NoCard as exc:
        print(f"no card: {exc}", file=sys.stderr)
        return 3
    leaked = runner.forbidden_modules()
    if leaked:
        print("the run loaded " + ", ".join(leaked), file=sys.stderr)
        return 4
    notes = res.pop("notes")
    if args.trace:
        notes["card"] = card_line()
    print(json.dumps(notes), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
