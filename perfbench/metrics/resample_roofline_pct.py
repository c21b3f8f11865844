"""resample_roofline_pct (%, layer kernels): the resampling's byte bound
(the distinct source samples its outputs need, read once, and the
[voices, frames] float32 output written once, at 3.35 TB/s) over the
device time of the resampling kernels (K1 ``unit_kernel``, K3-K5
``window_kernel``) in the profiled slice.  Nothing when neither ran."""

from harness import reduce


def read(rec: dict) -> float | None:
    return reduce.resample_roofline_pct(rec)
