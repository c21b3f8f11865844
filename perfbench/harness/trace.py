"""The traced run's instruments: host-clock spans from the benchmark's own
files, and ``torch.profiler`` over a fixed slice of calls inside the
window, reduced to a plain record that the per-layer metrics read.

The record (``record``):

- ``device_ops``: [(name, start_us, end_us)] of every device operation
  (kernels, copies, fills) in the slice;
- ``products``: {contracted size: device seconds} of the kernels that the
  matrix product ops (``aten::mm``, ``bmm``, ...) launched, from the
  profiler's recorded shapes;
- ``slice``: the profiled calls, their 1024-frame blocks and frames, and
  their wall seconds on the host clock;
- ``unprofiled``: the same for the window's other calls, with the spans'
  totals (``{"render_call": {"s": seconds, "n": count}}``);
- ``work``: the shapes the roofline shares need, from the scene recipe
  (voices, distinct source bytes of the slice).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

BENCH_SPANS = ("render_call",)
# The ops whose kernels are matrix products, and where their operands'
# contracted size sits in the recorded shapes.
PRODUCTS = {"aten::mm": 1, "aten::addmm": 2, "aten::bmm": 1,
            "aten::baddbmm": 2}
TOP = 10
ATTRIBUTED_GAPS = 500      # the longest idle gaps given a host label


class Spans:
    """``spans(name)`` times a block on the host clock; while a profile
    runs it also opens a ``torch.profiler.record_function`` range, and its
    time is kept apart from the unprofiled totals."""

    def __init__(self) -> None:
        self.totals: dict = defaultdict(lambda: {"s": 0.0, "n": 0})
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            import torch
            with torch.profiler.record_function(name):
                yield
            return
        t = time.perf_counter()
        yield
        tot = self.totals[name]
        tot["s"] += time.perf_counter() - t
        tot["n"] += 1


@contextlib.contextmanager
def no_spans(name: str):
    yield


def start_profile():
    import torch
    from torch.profiler import ProfilerActivity

    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA],
                                  record_shapes=True)
    prof.__enter__()
    return prof


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up, so the window's slice
    does not pay its first start."""
    import torch

    prof = start_profile()
    torch.ones(8, device=device).sum().item()
    prof.__exit__(None, None, None)


def _inner(name: str, shapes) -> int | None:
    """The contracted size of a matrix product op, from its shapes."""
    arg = PRODUCTS.get(name)
    if arg is None or not shapes or len(shapes) <= arg or not shapes[arg]:
        return None
    return int(shapes[arg][-2])


def stop_profile(prof) -> dict:
    """The slice's device operations and host events, as plain tuples, and
    the device seconds of the matrix products by contracted size (the
    kernels the profiler links to each product op, grouped by shapes)."""
    from torch.autograd import DeviceType

    prof.__exit__(None, None, None)
    dev_ops, host = [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # A record_function range also marks the device timeline.
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in BENCH_SPANS):
                dev_ops.append(item)
        else:
            host.append(item)
    products: dict = defaultdict(float)
    for avg in prof.key_averages(group_by_input_shape=True):
        inner = _inner(avg.key, avg.input_shapes)
        if inner is not None:
            products[inner] += 1e-6 * float(getattr(
                avg, "self_device_time_total",
                getattr(avg, "self_cuda_time_total", 0.0)))
    return {"device_ops": dev_ops, "host": host, "products": dict(products)}


def record(raw: dict, loop: str, blocks_per_call: int, frames: int,
           prof_calls: list, calls: list, spans: Spans, work: dict) -> dict:
    return {
        "loop": loop,
        "device_ops": raw["device_ops"],
        "host": raw["host"],
        "products": raw["products"],
        "slice": {"calls": len(prof_calls),
                  "blocks": len(prof_calls) * blocks_per_call,
                  "frames": len(prof_calls) * frames,
                  "wall_s": sum(e - s for s, e in prof_calls)},
        "unprofiled": {"calls": len(calls),
                       "blocks": len(calls) * blocks_per_call,
                       "wall_s": sum(e - s for s, e in calls),
                       "spans": {k: dict(v) for k, v in spans.totals.items()}},
        "work": work,
    }


def _containing(events: list, starts: np.ndarray, m: float, steps: int):
    """The event with the latest start that contains time m (the
    innermost, for nested events), looking back at most ``steps``."""
    i = int(np.searchsorted(starts, m, side="right")) - 1
    for j in range(i, max(i - steps, -1), -1):
        if events[j][2] >= m:
            return events[j][0]
    return None


def breakdown(rec: dict) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps inside the slice summed by what the host was doing."""
    by_op: dict = defaultdict(float)
    for name, s, e in rec["device_ops"]:
        by_op[name] += 1e-6 * (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    host = sorted(rec["host"], key=lambda h: h[1])
    spans = [h for h in host if h[0] in BENCH_SPANS]
    if not spans:
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": []}
    from .reduce import gaps

    lo = min(h[1] for h in spans)
    hi = max(h[2] for h in spans)
    idle = gaps([(op[1], op[2]) for op in rec["device_ops"]], lo, hi)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:ATTRIBUTED_GAPS]
    ops_host = [h for h in host if h[0] not in BENCH_SPANS]
    op_starts = np.array([h[1] for h in ops_host])
    span_starts = np.array([h[1] for h in spans])
    by_what: dict = defaultdict(float)
    for s, e in idle:
        m = 0.5 * (s + e)
        span = _containing(spans, span_starts, m, len(spans)) \
            or "between_calls"
        inner = _containing(ops_host, op_starts, m, 200)
        by_what[f"{span}/{inner}" if inner else span] += 1e-6 * (e - s)
    top = sorted(by_what.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in top]}
