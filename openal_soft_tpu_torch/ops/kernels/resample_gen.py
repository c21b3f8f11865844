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

This module also holds what K3, K4 (``resample_span``) and K5
(``resample_voice``) share, as their kernels share
``csrc/resample_window.cuh``: the meta layout, the bank
slice, and the size of a staged source window.  A window buffer holds
``window_frames(max_inc, taps)`` frames, the frames of ``TILE`` outputs at
the call's largest increment (``MAX_INC`` at most: the kernels cut a
faster voice's outputs into shorter windows, so every increment stays
exact); ``smem_bytes`` is a block's shared memory for it.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import (
    MAX_PITCH,
    MIXER_FRAC_BITS,
    MIXER_FRAC_MASK,
    RESAMPLE_TAPS,
)
from .. import resample as rs_ops
from ._build import check_tensor, load_library

resample_gen_ref = rs_ops.resample_voices
_BANK_KEYS = ("fil", "phd", "scd", "spd")
TILE = 1024                  # outputs a window covers at the largest increment
MAX_INC = MAX_PITCH << MIXER_FRAC_BITS   # the device's largest increment
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use


def window_frames(max_inc: int, taps: int) -> int:
    """Source frames of one window of TILE outputs at increments up to
    ``max_inc`` (16.16): ``(((TILE-1)*inc + 65535) >> 16) + taps + 1``."""
    return ((((TILE - 1) * int(max_inc) + MIXER_FRAC_MASK) >> MIXER_FRAC_BITS)
            + taps + 1)


def window_cap(max_inc: int | None, taps: int) -> int:
    """Frames of a kernel's window buffer for a call whose increments are
    at most ``max_inc`` (None: any the device makes)."""
    top = MAX_INC if max_inc is None else min(max(int(max_inc), 0), MAX_INC)
    return window_frames(top, taps)


def smem_bytes(cap: int, taps: int) -> int:
    """A block's shared memory: the W0/WD tables (32 x taps floats each)
    and the window buffer of cap + 3 frames rounded up to 16 bytes
    (csrc/resample_window.cuh buffer_floats)."""
    return 4 * (2 * 32 * taps + ((cap + 6) & ~3))


def launch_window_kernel(name: str, fn, pool, src_off, src_len, loop_start,
                         loop_end, has_loop, has_wrapped, pos_int, pos_frac,
                         increment, bank_row, sf, bank: dict, n: int,
                         taps: int, bank_sl, max_inc):
    """Check the inputs of a staged-window kernel (K3, K4, K5), size its
    window and launch ``fn`` (the C entry point) on the pool's device:
    [V, n] f32."""
    if not 1 <= taps <= RESAMPLE_TAPS:
        raise ValueError(f"{name}: taps={taps} outside 1..{RESAMPLE_TAPS}")
    if n <= 0 or pool.dim() != 1 or pool.numel() == 0:
        raise ValueError(f"{name}: need n > 0 and a non-empty 1-D pool")
    dev = pool.device
    V = src_off.shape[0]
    cap = window_cap(max_inc, taps)
    if smem_bytes(cap, taps) > SMEM_LIMIT:
        raise ValueError(f"{name}: a {cap}-frame window needs "
                         f"{smem_bytes(cap, taps)} bytes of shared memory, "
                         f"above {SMEM_LIMIT}")
    if bank_sl is None:
        bank_sl = slice_bank(bank, taps)
    check_tensor("pool", pool, torch.float32, (pool.numel(),), dev)
    check_tensor("bank_sl", bank_sl, torch.float32, (4, 52, 32, taps), dev)
    check_tensor("sf", sf, torch.float32, (V,), dev)
    meta = pack_meta(src_off, src_len, loop_start, loop_end, has_loop,
                     has_wrapped, pos_int, pos_frac, increment, bank_row)
    check_tensor("meta", meta, torch.int32, (V, 12), dev)
    out = torch.empty((V, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.data_ptr(), pool.numel(), meta.data_ptr(),
                 sf.data_ptr(), bank_sl.data_ptr(), out.data_ptr(), V, n,
                 taps, cap, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


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


def bind_window_launch(fn):
    """``fn`` (a staged-window kernel's C entry point) with its ctypes
    signature: pool, pool_len, meta, sf, bank, out, V, W, taps, cap,
    stream."""
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    return bind_window_launch(load_library("resample_gen").resample_gen_launch)


def resample_gen(pool, src_off, src_len, loop_start, loop_end, has_loop,
                 has_wrapped, pos_int, pos_frac, increment, bank_row, sf,
                 bank: dict, n: int, taps: int,
                 bank_sl: torch.Tensor | None = None,
                 max_inc: int | None = None) -> torch.Tensor:
    """Resample V voices at any pitch: [V, n] f32.

    Arguments as ``ops/resample.resample_voices``; on the card ``bank_sl``
    may pass ``slice_bank(bank, taps)`` prepared once, and ``max_inc`` a
    host bound on the increments that sizes the window (None: ``MAX_INC``;
    nothing is read back from the card).  Positions are taken in 64 bits,
    as in the plain version."""
    if pool.device.type == "cpu":
        return resample_gen_ref(pool, src_off, src_len, loop_start, loop_end,
                                has_loop, has_wrapped, pos_int, pos_frac,
                                increment, bank_row, sf, bank, n, taps)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_gen: unsupported device {pool.device}")
    out = launch_window_kernel(
        "resample_gen", _launcher(), pool, src_off, src_len, loop_start,
        loop_end, has_loop, has_wrapped, pos_int, pos_frac, increment,
        bank_row, sf, bank, n, taps, bank_sl, max_inc)
    resample_gen.launches += 1
    return out


resample_gen.launches = 0
