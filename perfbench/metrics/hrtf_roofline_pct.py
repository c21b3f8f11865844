"""hrtf_roofline_pct (%, layer mixing and HRTF): the HRTF contraction's
bound (2 x 2 ears x the HRIR set's taps x voices x frames at the 495
TFLOP/s TF32 tensor peak, against its float32 input and output at 3.35
TB/s) over the device time of the kernels launched by the matrix products
that contract over the voices, in the profiled slice (``trace.py`` ties
each kernel to its op by the profiler's recorded shapes).  Nothing when no
such product ran."""

from harness import reduce


def read(rec: dict) -> float | None:
    return reduce.hrtf_roofline_pct(rec)
