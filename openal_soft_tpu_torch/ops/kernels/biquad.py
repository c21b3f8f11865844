"""Dual interpolating biquad: the Hopper kernel's wrapper beside its plain
version.

The plain version is ``ops/filters.biquad_dual_interp`` (sample-sequential
TDF2, the 32-sample coefficient lerp), re-exported here as
``biquad_dual_ref``.  ``biquad_dual`` takes a CPU tensor to it and a CUDA
tensor to the kernel in ``csrc/biquad.cu`` (which replaces the TPU kernel
``openal_soft_tpu/ops/pallas/biquad.py`` ``_kernel``); the two are equal
bit for bit.  On the card there is no fallback: the kernel launches or the
wrapper raises.  ``biquad_dual.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import filters as f_ops
from ._build import check_tensor, load_library

biquad_dual_ref = f_ops.biquad_dual_interp


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("biquad").biquad_dual_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def biquad_dual(x: torch.Tensor, z: torch.Tensor, coeffs: torch.Tensor,
                target: torch.Tensor, counter: torch.Tensor):
    """Filter V lines through their two cascaded interpolating biquads.

    x [V, T] f32 with T % 32 == 0, 16-byte aligned (the kernel reads its
    rows as float4); z [V, 2, 2], coeffs and target [V, 2, 5] f32; counter
    [V] int32 (>= 0).  All contiguous and on x's device.
    Returns (y [V, T], z' [V, 2, 2], coeffs' [V, 2, 5], counter' [V])."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"biquad_dual: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[1] % 32:
        raise ValueError(f"biquad_dual: x must be [V, T] with V >= 1 and T "
                         f"a positive multiple of 32, got {tuple(x.shape)}")
    V, T = x.shape
    dev = x.device
    check_tensor("x", x, torch.float32, (V, T), dev)
    check_tensor("z", z, torch.float32, (V, 2, 2), dev)
    check_tensor("coeffs", coeffs, torch.float32, (V, 2, 5), dev)
    check_tensor("target", target, torch.float32, (V, 2, 5), dev)
    check_tensor("counter", counter, torch.int32, (V,), dev)
    if x.data_ptr() % 16:
        raise ValueError("biquad_dual: x is not 16-byte aligned")
    if dev.type == "cpu":
        return biquad_dual_ref(x, z, coeffs, target, counter)
    y = torch.empty_like(x)
    z2 = torch.empty_like(z)
    cf2 = torch.empty_like(coeffs)
    cnt2 = torch.empty_like(counter)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(x.data_ptr(), z.data_ptr(), coeffs.data_ptr(),
                     target.data_ptr(), counter.data_ptr(), y.data_ptr(),
                     z2.data_ptr(), cf2.data_ptr(), cnt2.data_ptr(), V, T,
                     stream)
    if err != 0:
        raise RuntimeError(f"biquad_dual kernel launch failed: CUDA error "
                           f"{err}")
    biquad_dual.launches += 1
    return y, z2, cf2, cnt2


biquad_dual.launches = 0
