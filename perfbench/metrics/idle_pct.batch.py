"""idle_pct.batch (%, layer device): 100 x (1 - the profiled slice's device
busy time per block, the union of its operation intervals, / the wall
time per block of the same run's unprofiled calls), in a batch cell."""

from harness import reduce


def read(rec: dict) -> float | None:
    return reduce.idle_pct(rec)
