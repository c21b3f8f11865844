"""General-pitch resampler: the Hopper kernel's wrapper beside its plain
version.

The plain version is ``ops/resample.resample_voices`` (every tier, any
increment), re-exported here as ``resample_gen_ref``.  ``resample_gen``
takes a CPU pool to it and a CUDA pool to the kernel in
``csrc/resample_gen.cu`` (which replaces the TPU kernel
``openal_soft_tpu/ops/pallas/resample3.py`` ``_kernel``).  The kernel reads
the weight bank sliced to the ``taps`` columns in use; ``slice_bank``
builds that slice once per tap count.  On the card there is no fallback:
the kernel launches or the wrapper raises.  ``resample_gen.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import RESAMPLE_TAPS
from .. import resample as rs_ops
from ._build import check_tensor, load_library

resample_gen_ref = rs_ops.resample_voices
_BANK_KEYS = ("fil", "phd", "scd", "spd")


def slice_bank(bank: dict, taps: int) -> torch.Tensor:
    """[4, 52, 32, taps] f32: fil, phd, scd, spd at the columns
    ``resample_voices`` reads for ``taps``."""
    lo = RESAMPLE_TAPS // 2 - taps // 2
    return torch.stack([bank[k][:, :, lo:lo + taps] for k in _BANK_KEYS]
                       ).contiguous()


def pack_meta(src_off, src_len, loop_start, loop_end, has_loop, has_wrapped,
              pos_int, pos_frac, increment, bank_row) -> torch.Tensor:
    """[V, 12] int32 per-voice scalars in the kernel's layout."""
    cols = (src_off, src_len, loop_start, loop_end, has_loop, has_wrapped,
            pos_int, pos_frac, increment, bank_row)
    meta = torch.stack([c.to(torch.int32) for c in cols], dim=1)
    return torch.nn.functional.pad(meta, (0, 2)).contiguous()


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("resample_gen").resample_gen_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resample_gen(pool, src_off, src_len, loop_start, loop_end, has_loop,
                 has_wrapped, pos_int, pos_frac, increment, bank_row, sf,
                 bank: dict, n: int, taps: int,
                 bank_sl: torch.Tensor | None = None) -> torch.Tensor:
    """Resample V voices at any pitch: [V, n] f32.

    Arguments as ``ops/resample.resample_voices``; on the card ``bank_sl``
    may pass ``slice_bank(bank, taps)`` prepared once.  Positions are
    taken in 64 bits, as in the plain version."""
    if pool.device.type == "cpu":
        return resample_gen_ref(pool, src_off, src_len, loop_start, loop_end,
                                has_loop, has_wrapped, pos_int, pos_frac,
                                increment, bank_row, sf, bank, n, taps)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_gen: unsupported device {pool.device}")
    if not 1 <= taps <= RESAMPLE_TAPS:
        raise ValueError(f"resample_gen: taps={taps} outside "
                         f"1..{RESAMPLE_TAPS}")
    if n <= 0 or pool.dim() != 1 or pool.numel() == 0:
        raise ValueError("resample_gen: need n > 0 and a non-empty 1-D pool")
    dev = pool.device
    V = src_off.shape[0]
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
                     taps, stream)
    if err != 0:
        raise RuntimeError(f"resample_gen kernel launch failed: CUDA "
                           f"error {err}")
    resample_gen.launches += 1
    return out


resample_gen.launches = 0
