"""General-pitch resampler for sample pools larger than L2: the Hopper
kernel's wrapper beside its plain version.

The plain version is ``ops/resample.resample_voices`` (every tier, any
increment), re-exported here as ``resample_span_ref``, as for
``resample_gen``.  ``resample_span`` takes a CPU pool to it and a CUDA
pool to the kernel in ``csrc/resample_span.cu`` (which replaces the TPU
kernel ``openal_soft_tpu/ops/pallas/resample2.py`` ``_kernel``).  The
kernel stages each (voice, 1024-output tile) source window in shared
memory, so every frame is read from device memory once per tile; its
shared memory is sized by ``window_frames`` for the largest increment.  On
the card there is no fallback: the kernel launches or the wrapper raises.
``resample_span.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import MIXER_FRAC_BITS, MIXER_FRAC_MASK, RESAMPLE_TAPS
from .. import resample as rs_ops
from ._build import check_tensor, load_library
from .resample_gen import pack_meta, slice_bank

resample_span_ref = rs_ops.resample_voices
TILE = 1024                  # outputs per thread block
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use


def window_frames(max_inc: int, taps: int) -> int:
    """Source frames of one tile's window at increments up to ``max_inc``
    (16.16): ``(((TILE-1)*inc + 65535) >> 16) + taps + 1``."""
    return ((((TILE - 1) * int(max_inc) + MIXER_FRAC_MASK) >> MIXER_FRAC_BITS)
            + taps + 1)


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("resample_span").resample_span_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resample_span(pool, src_off, src_len, loop_start, loop_end, has_loop,
                  has_wrapped, pos_int, pos_frac, increment, bank_row, sf,
                  bank: dict, n: int, taps: int,
                  bank_sl: torch.Tensor | None = None,
                  max_inc: int | None = None) -> torch.Tensor:
    """Resample V voices at any pitch: [V, n] f32.

    Arguments as ``ops/resample.resample_voices``; on the card ``bank_sl``
    may pass ``slice_bank(bank, taps)`` prepared once, and ``max_inc`` a
    host bound on every increment (else it is read from ``increment``,
    which waits for the card).  The pool must be 16-byte aligned."""
    if pool.device.type == "cpu":
        return resample_span_ref(pool, src_off, src_len, loop_start,
                                 loop_end, has_loop, has_wrapped, pos_int,
                                 pos_frac, increment, bank_row, sf, bank, n,
                                 taps)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_span: unsupported device {pool.device}")
    if not 1 <= taps <= RESAMPLE_TAPS:
        raise ValueError(f"resample_span: taps={taps} outside "
                         f"1..{RESAMPLE_TAPS}")
    if n <= 0 or pool.dim() != 1 or pool.numel() == 0:
        raise ValueError("resample_span: need n > 0 and a non-empty 1-D pool")
    if pool.data_ptr() % 16:
        raise ValueError("resample_span: the pool is not 16-byte aligned")
    dev = pool.device
    V = src_off.shape[0]
    if max_inc is None:
        max_inc = int(increment.max())
    cap = window_frames(max_inc, taps)
    if cap * 4 > SMEM_LIMIT:
        raise ValueError(f"resample_span: increment {max_inc} needs a "
                         f"{cap * 4}-byte window, above {SMEM_LIMIT}")
    if bank_sl is None:
        bank_sl = slice_bank(bank, taps)
    check_tensor("pool", pool, torch.float32, (pool.numel(),), dev)
    check_tensor("bank_sl", bank_sl, torch.float32, (4, 52, 32, taps), dev)
    check_tensor("sf", sf, torch.float32, (V,), dev)
    meta = pack_meta(src_off, src_len, loop_start, loop_end, has_loop,
                     has_wrapped, pos_int, pos_frac, increment, bank_row)
    check_tensor("meta", meta, torch.int32, (V, 12), dev)
    out = torch.empty((V, n), dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(pool.data_ptr(), pool.numel(), meta.data_ptr(),
                     sf.data_ptr(), bank_sl.data_ptr(), out.data_ptr(), V, n,
                     taps, cap, stream)
    if err != 0:
        raise RuntimeError(f"resample_span kernel launch failed: CUDA "
                           f"error {err}")
    resample_span.launches += 1
    return out


resample_span.launches = 0
