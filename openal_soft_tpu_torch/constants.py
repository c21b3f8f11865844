"""Structural constants of the renderer.

These mirror the reference's workload-defining constants (see BASELINE.md)
so output is comparable sample-for-sample:

* block size:            core/bufferline.h:11   (BufferLineSize = 1024)
* fixed-point fraction:  core/mixer/defs.h:23   (16-bit)
* silence threshold:     core/mixer/defs.h:28   (-100 dB)
* resampler padding:     core/resampler_limits.h:8
* HRIR geometry:         core/mixer/hrtfdefs.h:15-23
* ambisonics:            core/ambidefs.h:18-19
* voice/send limits:     core/voice.h:31-35
"""

from __future__ import annotations

import enum

# --- Mix block geometry -----------------------------------------------------
BUFFER_LINE_SIZE = 1024          # samples per mix line / render block
MAX_OUTPUT_CHANNELS = 16
MIXER_CHANNELS_MAX = 25          # max mixing channels for a single voice

# --- Fixed-point resampler position format ----------------------------------
MIXER_FRAC_BITS = 16
MIXER_FRAC_ONE = 1 << MIXER_FRAC_BITS
MIXER_FRAC_MASK = MIXER_FRAC_ONE - 1
MIXER_FRAC_HALF = MIXER_FRAC_ONE >> 1

GAIN_SILENCE_THRESHOLD = 1.0e-5  # -100 dB

MAX_PITCH = 10                   # max resample ratio

# --- Resampler paddings -----------------------------------------------------
MAX_RESAMPLER_PADDING = 48       # symmetric: half before, half after
MAX_RESAMPLER_EDGE = MAX_RESAMPLER_PADDING >> 1

# --- Table geometry ----------------------------------------------------------
CUBIC_PHASE_BITS = 5
CUBIC_PHASE_COUNT = 1 << CUBIC_PHASE_BITS
BSINC_SCALE_BITS = 4
BSINC_SCALE_COUNT = 1 << BSINC_SCALE_BITS
BSINC_PHASE_BITS = 5
BSINC_PHASE_COUNT = 1 << BSINC_PHASE_BITS

# Phase sub-precision used by the kernels (frac bits below the phase index).
CUBIC_PHASE_DIFF_BITS = MIXER_FRAC_BITS - CUBIC_PHASE_BITS
CUBIC_PHASE_DIFF_ONE = 1 << CUBIC_PHASE_DIFF_BITS
CUBIC_PHASE_DIFF_MASK = CUBIC_PHASE_DIFF_ONE - 1
BSINC_PHASE_DIFF_BITS = MIXER_FRAC_BITS - BSINC_PHASE_BITS
BSINC_PHASE_DIFF_ONE = 1 << BSINC_PHASE_DIFF_BITS
BSINC_PHASE_DIFF_MASK = BSINC_PHASE_DIFF_ONE - 1

# --- HRTF -------------------------------------------------------------------
HRTF_HISTORY_BITS = 6
HRTF_HISTORY_LENGTH = 1 << HRTF_HISTORY_BITS     # 64
HRIR_BITS = 7
HRIR_LENGTH = 1 << HRIR_BITS                     # 128 taps
MIN_IR_LENGTH = 8
MAX_HRIR_DELAY = HRTF_HISTORY_LENGTH - 1
HRIR_DELAY_FRAC_BITS = 2
HRIR_DELAY_FRAC_ONE = 1 << HRIR_DELAY_FRAC_BITS  # delays stored in 1/4 samples
HRIR_DELAY_FRAC_HALF = HRIR_DELAY_FRAC_ONE >> 1

# --- Ambisonics ---------------------------------------------------------------
MAX_AMBI_ORDER = 4
MAX_AMBI_CHANNELS = (MAX_AMBI_ORDER + 1) ** 2    # 25
MAX_AMBI2D_ORDER = 14  # not used yet; reference supports high 2D orders in buffers

# --- Voice / device limits ----------------------------------------------------
MAX_SEND_COUNT = 6
DEFAULT_VOICES = 256
DEFAULT_SENDS = 2
GAIN_FADE_SAMPLES = 64            # gain-change linear fade length (min w/ block)

DEFAULT_OUTPUT_RATE = 48000
MIN_OUTPUT_RATE = 8000
MAX_OUTPUT_RATE = 192000
DEFAULT_UPDATE_SIZE = 512
DEFAULT_NUM_UPDATES = 3

DEFAULT_XOVER_FREQ = 400.0        # speaker dual-band crossover
HRTF_XOVER_FREQ = 700.0           # HRTF decode crossover


class Resampler(enum.IntEnum):
    """Resampler quality tiers (core/mixer/defs.h:31-44)."""
    POINT = 0
    LINEAR = 1
    SPLINE = 2
    GAUSSIAN = 3
    FAST_BSINC12 = 4
    BSINC12 = 5
    FAST_BSINC24 = 6
    BSINC24 = 7
    FAST_BSINC48 = 8
    BSINC48 = 9


RESAMPLER_DEFAULT = Resampler.SPLINE   # core/voice.h:35

RESAMPLER_NAMES = {
    "none": Resampler.POINT,
    "point": Resampler.POINT,
    "linear": Resampler.LINEAR,
    "spline": Resampler.SPLINE,
    "gaussian": Resampler.GAUSSIAN,
    "bsinc12": Resampler.BSINC12,
    "fast_bsinc12": Resampler.FAST_BSINC12,
    "bsinc24": Resampler.BSINC24,
    "fast_bsinc24": Resampler.FAST_BSINC24,
    "bsinc48": Resampler.BSINC48,
    "fast_bsinc48": Resampler.FAST_BSINC48,
    # deprecated aliases
    "cubic": Resampler.SPLINE,
    "sinc4": Resampler.GAUSSIAN,
    "sinc8": Resampler.GAUSSIAN,
    "bsinc": Resampler.BSINC12,
}

# Decoder padding (post-resample samples needed by UHJ/SuperStereo decoders)
# is voice-dependent; 0 for plain voices.

# Unified gather window for the batched device resampler: every output sample
# reads source window [pos - RESAMPLE_L, pos + RESAMPLE_TAPS - RESAMPLE_L).
# 48-tap window centered like bsinc48 (l = m/2 - 1 = 23).
RESAMPLE_TAPS = 48
RESAMPLE_L = RESAMPLE_TAPS // 2 - 1   # 23
