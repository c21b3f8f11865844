"""Host time inside the program's own ``torch.profiler`` ranges, read from
the traced run's record (``trace.record``'s host events, by name).

The profiler adds its own cost to every operation it records, so host time
inside a range is longer in the profiled slice than in the unprofiled
calls, and by more in a range that issues many operations.  A range is
therefore read as its share of the slice's host wall, and that share is
put on the unprofiled calls' wall per block: the layer's part of the wall
a user sees, in milliseconds a block, as far as the profiler's cost falls
evenly on the layers."""

from __future__ import annotations


def ms_per_block(rec: dict, name: str) -> float | None:
    """The ranges called ``name``: their share of the profiled slice's
    host wall, times the unprofiled calls' wall per 1024-frame block, in
    ms; nothing when the program opened no such range (one that has none,
    or an HRTF cell) or the window had no unprofiled call."""
    spans = [e - s for n, s, e in rec["host"] if n == name]
    free = rec["unprofiled"]
    if not spans or not free["blocks"] or rec["slice"]["wall_s"] <= 0:
        return None
    share = 1e-6 * sum(spans) / rec["slice"]["wall_s"]
    return share * 1e3 * free["wall_s"] / free["blocks"]
