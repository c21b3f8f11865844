"""Tensor ops of the render path (port of openal_soft_tpu/ops): the plain
resampler, the HRTF contractions, the mixes, the filters, and the kernels."""
