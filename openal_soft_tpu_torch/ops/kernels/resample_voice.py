"""General-pitch resampler, one voice per thread block: the Hopper kernel's
wrapper beside its plain version.

The plain version is ``ops/resample.resample_voices``, re-exported here as
``resample_voice_ref``.  ``resample_voice`` takes a CPU pool to it and a
CUDA pool to the kernel in ``csrc/resample_voice.cu`` (which replaces the
TPU kernel ``openal_soft_tpu/ops/pallas/resample.py`` ``_kernel``).  Each
block stages two windows of ``span_for_increment`` frames (the TPU
kernel's buckets); the wrapper raises where the largest bucket cannot
cover a voice's outputs, where the TPU kernel returned zeros.  The render
device does not route to it (neither does the JAX package's); it is held
against its plain version and timed by ``chip_smoke.py``.  On the card
there is no fallback: the kernel launches or the wrapper raises.
``resample_voice.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...constants import MIXER_FRAC_BITS, RESAMPLE_TAPS
from .. import resample as rs_ops
from ._build import check_tensor, load_library
from .resample_gen import pack_meta, slice_bank

resample_voice_ref = rs_ops.resample_voices
# Window buckets (source frames), the TPU kernel's: sized for 1024 outputs
# at ~1x/2x/4x/10x pitch.
SPAN_BUCKETS = (2048, 3072, 5120, 11264)


def span_frames_needed(max_inc: int, n: int) -> int:
    """Frames one window must hold for ``n`` outputs at increments up to
    ``max_inc`` (16.16): ``((max_inc * n) >> 16) + 64``."""
    return ((int(max_inc) * n) >> MIXER_FRAC_BITS) + 64


def span_for_increment(max_inc: int, n: int) -> int:
    """The smallest bucket that holds ``span_frames_needed``; raises when
    none does."""
    need = span_frames_needed(max_inc, n)
    for span in SPAN_BUCKETS:
        if need <= span:
            return span
    raise ValueError(f"resample_voice: {n} outputs at increment {max_inc} "
                     f"need a {need}-frame window, above the largest "
                     f"bucket ({SPAN_BUCKETS[-1]})")


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    fn = load_library("resample_voice").resample_voice_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resample_voice(pool, src_off, src_len, loop_start, loop_end, has_loop,
                   has_wrapped, pos_int, pos_frac, increment, bank_row, sf,
                   bank: dict, n: int, taps: int,
                   bank_sl: torch.Tensor | None = None,
                   max_inc: int | None = None) -> torch.Tensor:
    """Resample V voices at any pitch: [V, n] f32.

    Arguments as ``ops/resample.resample_voices``; ``bank_sl`` and
    ``max_inc`` as for ``resample_span``.  Raises (on either device) when
    ``((max_inc * n) >> 16) + 64`` exceeds the largest window bucket."""
    if max_inc is None:
        max_inc = int(increment.max())
    span = span_for_increment(max_inc, n)
    if pool.device.type == "cpu":
        return resample_voice_ref(pool, src_off, src_len, loop_start,
                                  loop_end, has_loop, has_wrapped, pos_int,
                                  pos_frac, increment, bank_row, sf, bank, n,
                                  taps)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_voice: unsupported device {pool.device}")
    if not 1 <= taps <= RESAMPLE_TAPS:
        raise ValueError(f"resample_voice: taps={taps} outside "
                         f"1..{RESAMPLE_TAPS}")
    if n <= 0 or pool.dim() != 1 or pool.numel() == 0:
        raise ValueError("resample_voice: need n > 0 and a non-empty 1-D "
                         "pool")
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
                     taps, span, stream)
    if err != 0:
        raise RuntimeError(f"resample_voice kernel launch failed: CUDA "
                           f"error {err}")
    resample_voice.launches += 1
    return out


resample_voice.launches = 0
