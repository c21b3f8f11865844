"""Tensor ops of the render path (port of openal_soft_tpu/ops): the plain
resampler, the HRTF contractions, host filter helpers, and the kernels."""
