"""General-pitch resampler for sample pools larger than L2: the Hopper
kernel's wrapper beside its plain version.

The plain version is ``ops/resample.resample_voices`` (every tier, any
increment), re-exported here as ``resample_span_ref``, as for
``resample_gen``.  ``resample_span`` takes a CPU pool to it and a CUDA
pool to the kernel in ``csrc/resample_span.cu`` (which replaces the TPU
kernel ``openal_soft_tpu/ops/pallas/resample2.py`` ``_kernel``).  The
kernel runs K3's staged-window design (``csrc/resample_window.cuh``):
each block stages a voice's weight tables and its resolved source windows
in shared memory, each window read from device memory once, sized by
``window_frames`` for the largest increment.  On the
card there is no fallback: the kernel launches or the wrapper raises.
``resample_span.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import resample as rs_ops
from ._build import load_library
from .resample_gen import (  # noqa: F401  (TILE, window_frames: re-exported)
    TILE,
    bind_window_launch,
    launch_window_kernel,
    window_frames,
)

resample_span_ref = rs_ops.resample_voices


def _launcher():
    """The C entry point, built on first use, with its ctypes signature."""
    return bind_window_launch(
        load_library("resample_span").resample_span_launch)


def resample_span(pool, src_off, src_len, loop_start, loop_end, has_loop,
                  has_wrapped, pos_int, pos_frac, increment, bank_row, sf,
                  bank: dict, n: int, taps: int,
                  bank_sl: torch.Tensor | None = None,
                  max_inc: int | None = None) -> torch.Tensor:
    """Resample V voices at any pitch: [V, n] f32.

    Arguments as ``ops/resample.resample_voices``; on the card ``bank_sl``
    may pass ``slice_bank(bank, taps)`` prepared once, and ``max_inc`` a
    host bound on the increments that sizes the windows (None:
    ``MAX_INC``; nothing is read back from the card)."""
    if pool.device.type == "cpu":
        return resample_span_ref(pool, src_off, src_len, loop_start,
                                 loop_end, has_loop, has_wrapped, pos_int,
                                 pos_frac, increment, bank_row, sf, bank, n,
                                 taps)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_span: unsupported device {pool.device}")
    out = launch_window_kernel(
        "resample_span", _launcher(), pool, src_off, src_len,
        loop_start, loop_end, has_loop, has_wrapped, pos_int, pos_frac,
        increment, bank_row, sf, bank, n, taps, bank_sl, max_inc)
    resample_span.launches += 1
    return out


resample_span.launches = 0
