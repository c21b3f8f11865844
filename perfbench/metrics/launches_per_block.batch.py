"""launches_per_block.batch (ops/block, layer dispatch): device operations
(kernels, copies, fills) that torch.profiler records in the profiled
slice of a batch cell, per 1024-frame block."""

from harness import reduce


def read(rec: dict) -> float | None:
    return reduce.launches_per_block(rec)
