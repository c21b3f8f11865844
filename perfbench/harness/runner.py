"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, and the comparison with the reference once the window has closed.

    run_cell(cell, seed, seconds, trace) -> the result line's object

The scene recipe (``scenes/<scene>.py``) makes the inputs from the seed and
hands the same to the program and to the reference.  The window is a
closed loop with one caller (``loops/<loop>.py``): each call starts when
the last one has returned.  End-to-end metrics are taken over every call
of the window with tracing off; the ``--trace 1`` run profiles a fixed
slice of ``trace_calls`` calls inside its window and reports the
per-layer metrics instead.  Once the window has closed and the program's
objects are freed, the reference renders the frames of the compared calls
from the inputs alone.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time

import numpy as np

from . import check, inputs, reduce, registry, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "openal_soft_tpu")
# The HRTF data set both sides read: the raw file OpenAL Soft ships as
# "Default HRTF.mhr", under a name the benchmark's paths allow.
HRTF_DIR = registry.BENCH_DIR / "data"
HRTF_NAME = "default_hrtf"
HRTF_PATH = HRTF_DIR / f"{HRTF_NAME}.mhr"


class NoCard(RuntimeError):
    """The cell's chips are not there; the run prints no result."""


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole (``openal_soft_tpu_torch`` is not ``openal_soft_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} card(s), the cell asks "
                     f"for {chips}")


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


@contextlib.contextmanager
def alsoft_conf(cell):
    """The configuration's ``alsoft.conf`` text, with the benchmark's HRTF
    data set, in a file the program reads through ``ALSOFT_CONF``."""
    fd, conf = tempfile.mkstemp(suffix=".conf")
    with os.fdopen(fd, "w") as fh:
        fh.write(f"[general]\nhrtf-paths = {HRTF_DIR}\n"
                 f"default-hrtf = {HRTF_NAME}\n")
        fh.write(cell.config["alsoft_conf"])
    os.environ["ALSOFT_CONF"] = conf
    try:
        yield
    finally:
        os.environ.pop("ALSOFT_CONF", None)
        os.remove(conf)


def scene_module(cell):
    return registry.load_module("scenes", cell.traffic["scene"],
                                cell.bench_dir)


def scene_inputs(cell, seed: int) -> dict:
    return scene_module(cell).inputs(cell.traffic["scene_params"], seed,
                                     cell.config["device"]["frequency"])


def compared_calls(cell, seed: int) -> int:
    """The call of the window that is compared, drawn from the seed."""
    warm = int(cell.traffic["warm_calls"])
    return warm + int(inputs.rng(seed, 2).integers(
        0, int(cell.traffic["compare_within"])))


def compare(cell, scene: dict, outs: dict, device: str) -> dict:
    """Each call's gap: ``outs`` maps a name to (call index, the program's
    output); the reference renders those frames from the inputs."""
    import torch

    frames = int(cell.traffic["loop_params"]["call_blocks"]) * 1024
    ref = scene_module(cell).reference(cell.config, scene, HRTF_PATH,
                                       device, torch.float64)
    names = list(outs)
    refs = ref.render_compared([(outs[n][0] * frames, frames, outs[n][1])
                                for n in names])
    values = {n: check.out_gap(outs[n][1], r) for n, r in zip(names, refs)}
    values["ties"] = len(ref.ties)
    del ref
    return values


def _release(al) -> None:
    """Drop the program's objects: its current context holds the device."""
    al.alcMakeContextCurrent(None)
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _run_program(cell, scene, seed, seconds, trace, device, k_cmp, t0):
    """Set-up, warm-up, the window and the traced slice; the program's
    objects are freed before it returns."""
    from openal_soft_tpu_torch.al import api as al
    from openal_soft_tpu_torch.alc import config

    tr = cell.traffic
    warm = int(tr["warm_calls"])
    config.load_config(reload=True)
    built = scene_module(cell).build(al, cell.config, scene, device)
    loop = registry.load_module("loops", tr["loop"], cell.bench_dir).Loop(
        built, tr["loop_params"], seed)
    dev = built["dev"]
    n_out = dev.n_real
    out0 = None
    for k in range(warm):
        out = loop.call(k, tracing.no_spans)
        if k == 0:
            out0 = out.copy()
    if trace:
        tracing.warm_profiler(device)
    _sync(device)

    # The window.
    first = warm + 1
    last = first + int(tr["trace_calls"]) if trace else first
    spans = tracing.Spans()
    calls, prof_calls, kept = [], [], {"first_gap": (0, out0)}
    failed, prof, raw = 0, None, None
    k = warm
    t_start = time.perf_counter()
    setup_s = t_start - t0
    while True:
        in_slice = first <= k < last
        if in_slice and prof is None:
            prof = tracing.start_profile()
            spans.profiling = True
        s = time.perf_counter()
        out = loop.call(k, spans)
        e = time.perf_counter()
        if out.shape != (loop.frames, n_out) or not np.isfinite(out).all():
            failed += 1
        if k == k_cmp:
            kept["out_gap"] = (k, out.copy())
        (prof_calls if in_slice else calls).append((s, e))
        k += 1
        if in_slice and k == last:
            spans.profiling = False
            raw = tracing.stop_profile(prof)
        if e - t_start >= seconds and k >= last:
            break
    kept["last_gap"] = (k - 1, out.copy())
    attempted = len(calls) + len(prof_calls)
    while k <= k_cmp:                   # a short window: go on to call k
        out = loop.call(k, tracing.no_spans)
        if k == k_cmp:
            kept["out_gap"] = (k, out.copy())
        k += 1
    _sync(device)

    if trace:
        work = scene_module(cell).work(scene, HRTF_PATH,
                                       len(prof_calls) * loop.frames)
        rec = tracing.record(raw, tr["loop"], loop.blocks, loop.frames,
                             prof_calls, calls, spans, work)
        metrics = {}
        for m in cell.per_layer:
            v = registry.load_module("metrics", m["name"],
                                     cell.bench_dir).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rec = None
        values = loop.end_to_end(calls)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    info = _device_info(device, cell.chips)
    if rec is not None:
        info["busy_s"] = reduce.busy_s(rec)
        info["window_s"] = rec["slice"]["wall_s"]
    del built, loop, dev, out
    _release(al)
    return metrics, info, rec, kept, failed, attempted


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None) -> dict:
    t0 = time.perf_counter() if t0 is None else t0
    if device.startswith("cuda"):
        require_card(cell.chips)
    k_cmp = compared_calls(cell, seed)
    scene = scene_inputs(cell, seed)
    with alsoft_conf(cell):
        program = _run_program(cell, scene, seed, seconds, trace, device,
                               k_cmp, t0)
    metrics, info, rec, kept, failed, attempted = program
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError("the run loaded " + ", ".join(leaked))

    # The reference, once the program's objects are freed.
    t_ref = time.perf_counter()
    values = compare(cell, scene, kept, device)
    values["failed"] = failed
    ties = values.pop("ties")
    ref_s = time.perf_counter() - t_ref

    ok, checks = check.judge(values, cell.checks)
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": info}
    if rec is not None:
        result["breakdown"] = tracing.breakdown(rec)
    result["checks"] = checks
    result["notes"] = {"compared_calls": {n: c for n, (c, _) in
                                          kept.items()},
                       "reference_s": ref_s, "calls": attempted,
                       "round_off_ties": ties}
    return result


def _device_info(device: str, chips: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
