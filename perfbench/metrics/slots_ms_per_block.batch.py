"""slots_ms_per_block.batch (ms/block, layer effect slots): host time
inside the program's ``alsoft.slots`` ranges (every slot's effect: the
reverbs, their upmix and their mix onto the dry bus), as a share of the
profiled slice's host wall, put on the unprofiled calls' wall per
1024-frame block (``harness/ranges.py``).  Nothing where the program opens
no such range."""

from harness import ranges


def read(rec: dict) -> float | None:
    return ranges.ms_per_block(rec, "alsoft.slots")
