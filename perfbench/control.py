#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size:

- the control: the reference in the program's place, computed in float32
  with TF32 on (the precision below the configuration's float32 with TF32
  off), renders the calls a run compares (call 0, the seed's call k, and
  a later call drawn from the seed), which are judged against the float64
  reference as a run's are.  It has to come out not correct;
- the program's own runs (``--program-seeds``), each a whole run with a
  short window, in one process.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        [--program-seeds <n> ...] [--seconds <s>]

Prints one JSON line per seed with each compared number beside its limit.
Needs the card; the benchmark's own runs never run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:1] = [str(HERE), str(HERE.parent)]

LATER_CALLS = 700      # about the calls of a full window of the batch loop


def control(cell, seed: int) -> dict:
    """The control's outputs of the compared calls, judged."""
    import torch

    from harness import check, inputs, runner

    scene = runner.scene_inputs(cell, seed)
    k = runner.compared_calls(cell, seed)
    later = k + 1 + int(inputs.rng(seed, 3).integers(0, LATER_CALLS))
    frames = int(cell.traffic["loop_params"]["call_blocks"]) * 1024
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = runner.scene_module(cell).reference(
            cell.config, scene, runner.HRTF_PATH, "cuda", torch.float32)
        outs = {name: (c, low.render(c * frames, frames)) for name, c in
                (("first_gap", 0), ("out_gap", k), ("last_gap", later))}
        del low
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    values = runner.compare(cell, scene, outs, "cuda")
    values["failed"] = 0
    values.pop("ties")
    ok, checks = check.judge(values, cell.checks)
    return {"correct": ok, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    from harness import registry, runner

    cell = registry.cell(registry.load_bench(), args.workload)
    runner.require_card(cell.chips)
    failed_all = True
    for seed in args.seeds:
        res = control(cell, seed)
        failed_all &= not res["correct"]
        print(json.dumps({"workload": args.workload, "side": "control",
                          "seed": seed, **res}), flush=True)
    for seed in args.program_seeds:
        res = runner.run_cell(cell, seed, args.seconds, False)
        print(json.dumps({"workload": args.workload, "side": "program",
                          "seed": seed, "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
