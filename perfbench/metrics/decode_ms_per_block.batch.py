"""decode_ms_per_block.batch (ms/block, layer output decode): host time
inside the program's ``alsoft.decode`` ranges (the band splitter and the
decode of the dry bus to the speakers), as a share of the profiled slice's
host wall, put on the unprofiled calls' wall per 1024-frame block
(``harness/ranges.py``).  Nothing where the program opens no such
range."""

from harness import ranges


def read(rec: dict) -> float | None:
    return ranges.ms_per_block(rec, "alsoft.decode")
