"""Hand-written Hopper kernels, each with its plain torch version and a
wrapper that takes CPU tensors to the plain version and CUDA tensors to
the kernel (port of openal_soft_tpu/ops/pallas)."""
