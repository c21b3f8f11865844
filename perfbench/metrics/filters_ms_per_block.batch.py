"""filters_ms_per_block.batch (ms/block, layer filters): host time inside
the program's ``alsoft.filters`` ranges (the voices' direct and send
lowpasses, K7), as a share of the profiled slice's host wall, put on the
unprofiled calls' wall per 1024-frame block (``harness/ranges.py``).
Nothing where the program opens no such range."""

from harness import ranges


def read(rec: dict) -> float | None:
    return ranges.ms_per_block(rec, "alsoft.filters")
