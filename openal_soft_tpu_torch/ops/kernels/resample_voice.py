"""General-pitch resampler, one voice per thread block: the Hopper kernel's
wrapper beside its plain version.

The plain version is ``ops/resample.resample_voices``, re-exported here as
``resample_voice_ref``.  ``resample_voice`` takes a CPU pool to it and a
CUDA pool to the kernel in ``csrc/resample_voice.cu`` (which replaces the
TPU kernel ``openal_soft_tpu/ops/pallas/resample.py`` ``_kernel``): the
staged-window kernel of K3 and K4 (``csrc/resample_window.cuh``) with one
block per voice, its row cut into windows sized by ``window_frames`` for
the call's largest increment.  The wrapper keeps the TPU kernel's limit:
it raises where ``span_for_increment`` finds no window bucket (2048-11264
frames) that covers a voice's outputs, where the TPU kernel returned
zeros.  The render device does not route to it (neither does the JAX
package's); it is held against its plain version and timed by
``chip_smoke.py``.  On the card there is no fallback: the kernel launches
or the wrapper raises.  ``resample_voice.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from ...constants import MIXER_FRAC_BITS
from .. import resample as rs_ops
from ._build import load_library
from .resample_gen import bind_window_launch, launch_window_kernel

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
    return bind_window_launch(
        load_library("resample_voice").resample_voice_launch)


def resample_voice(pool, src_off, src_len, loop_start, loop_end, has_loop,
                   has_wrapped, pos_int, pos_frac, increment, bank_row, sf,
                   bank: dict, n: int, taps: int,
                   bank_sl: torch.Tensor | None = None,
                   max_inc: int | None = None) -> torch.Tensor:
    """Resample V voices at any pitch: [V, n] f32.

    Arguments as ``ops/resample.resample_voices``; ``bank_sl`` and
    ``max_inc`` as for ``resample_span`` (None: ``max(increment)``, read
    back from the pool's device).  Raises (on either device) when
    ``((max_inc * n) >> 16) + 64`` exceeds the largest window bucket."""
    if max_inc is None:
        max_inc = int(increment.max())
    span_for_increment(max_inc, n)
    if pool.device.type == "cpu":
        return resample_voice_ref(pool, src_off, src_len, loop_start,
                                  loop_end, has_loop, has_wrapped, pos_int,
                                  pos_frac, increment, bank_row, sf, bank, n,
                                  taps)
    if pool.device.type != "cuda":
        raise ValueError(f"resample_voice: unsupported device {pool.device}")
    out = launch_window_kernel(
        "resample_voice", _launcher(), pool, src_off, src_len, loop_start,
        loop_end, has_loop, has_wrapped, pos_int, pos_frac, increment,
        bank_row, sf, bank, n, taps, bank_sl, max_inc)
    resample_voice.launches += 1
    return out


resample_voice.launches = 0
