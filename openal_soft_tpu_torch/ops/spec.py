"""Numpy specification oracle for the mixer kernels.

Scalar-faithful re-statements of the reference's C mixer kernels
(core/mixer/mixer_c.cpp, core/mixer/hrtfbase.h, core/filters/biquad.cpp),
computed in numpy float32 with the same operation order, used as the golden
oracle that the batched TPU kernels are tested against.  These are NOT used
on the render path — they exist so every device kernel has an executable
spec (the reference ships no DSP unit tests; see SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    BSINC_PHASE_DIFF_BITS,
    BSINC_PHASE_DIFF_MASK,
    BSINC_PHASE_DIFF_ONE,
    CUBIC_PHASE_DIFF_BITS,
    CUBIC_PHASE_DIFF_MASK,
    CUBIC_PHASE_DIFF_ONE,
    GAIN_SILENCE_THRESHOLD,
    HRIR_LENGTH,
    HRTF_HISTORY_LENGTH,
    MAX_RESAMPLER_EDGE,
    MIXER_FRAC_BITS,
    MIXER_FRAC_MASK,
    MIXER_FRAC_ONE,
)
from .tables import BSincTable, bsinc_prepare

f32 = np.float32


def _positions(frac: int, increment: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(pos[i], frac[i]) streams per DoResample (mixer_c.cpp:107-121)."""
    fr = frac + np.arange(n, dtype=np.int64) * increment
    return (fr >> MIXER_FRAC_BITS).astype(np.int64), (fr & MIXER_FRAC_MASK).astype(np.int64)


def resample_point(src: np.ndarray, frac: int, increment: int, n: int) -> np.ndarray:
    """Resample_Point_C: src holds MaxResamplerEdge pre-padding samples."""
    pos, _ = _positions(frac, increment, n)
    return src[MAX_RESAMPLER_EDGE + pos].astype(f32)


def resample_linear(src: np.ndarray, frac: int, increment: int, n: int) -> np.ndarray:
    pos, fr = _positions(frac, increment, n)
    base = MAX_RESAMPLER_EDGE + pos
    a = src[base].astype(f32)
    b = src[base + 1].astype(f32)
    mu = fr.astype(f32) * f32(1.0 / MIXER_FRAC_ONE)
    return (a + (b - a) * mu).astype(f32)  # lerpf(a, b, mu)


def resample_cubic(table: tuple[np.ndarray, np.ndarray], src: np.ndarray,
                   frac: int, increment: int, n: int) -> np.ndarray:
    """Resample_Cubic_C with a (coeffs[32,4], deltas[32,4]) table."""
    coeffs, deltas = table
    pos, fr = _positions(frac, increment, n)
    pi = (fr >> CUBIC_PHASE_DIFF_BITS).astype(np.int64)
    pf = (fr & CUBIC_PHASE_DIFF_MASK).astype(f32) * f32(1.0 / CUBIC_PHASE_DIFF_ONE)
    base = MAX_RESAMPLER_EDGE - 1 + pos
    out = np.zeros(n, dtype=f32)
    for j in range(4):
        w = (coeffs[pi, j] + pf * deltas[pi, j]).astype(f32)
        out = (out + w * src[base + j].astype(f32)).astype(f32)
    return out


def resample_bsinc(table: BSincTable, src: np.ndarray, frac: int, increment: int,
                   n: int, fast: bool = False) -> np.ndarray:
    """Resample_BSinc_C / Resample_FastBSinc_C."""
    si, sf = bsinc_prepare(table, increment)
    m = int(table.m[si])
    ell = m // 2 - 1
    off = int(table.filter_offset[si])
    flat = table.flat
    pos, fr = _positions(frac, increment, n)
    pi = (fr >> BSINC_PHASE_DIFF_BITS).astype(np.int64)
    pf = (fr & BSINC_PHASE_DIFF_MASK).astype(f32) * f32(1.0 / BSINC_PHASE_DIFF_ONE)
    base = MAX_RESAMPLER_EDGE - ell + pos
    out = np.zeros(n, dtype=f32)
    for j in range(m):
        filv = flat[off + 2 * pi * m + j]
        phdv = flat[off + 2 * pi * m + m + j]
        if fast:
            w = (filv + pf * phdv).astype(f32)
        else:
            scdv = flat[off + 32 * 2 * m + 2 * pi * m + j]
            spdv = flat[off + 32 * 2 * m + 2 * pi * m + m + j]
            w = (filv + sf * scdv + pf * (phdv + sf * spdv)).astype(f32)
        out = (out + w * src[base + j].astype(f32)).astype(f32)
    return out


# ---------------------------------------------------------------------------
# Gain-ramped mixing (MixLine, mixer_c.cpp:150-186)
# ---------------------------------------------------------------------------


def mix_line(in_samples: np.ndarray, dst: np.ndarray, current_gain: float,
             target_gain: float, counter: int, out_pos: int = 0) -> f32:
    """Accumulate in_samples into dst[out_pos:] with a linear gain ramp.

    Returns the updated current gain.  Mirrors MixLine exactly, including
    the step-epsilon branch, the fade cut at `counter`, and the -100 dB
    silence skip on the steady tail.
    """
    n = len(in_samples)
    delta = f32(1.0 / counter) if counter > 0 else f32(0.0)
    fade_len = min(counter, n)
    current_gain = f32(current_gain)
    target_gain = f32(target_gain)
    step = f32((target_gain - current_gain) * delta)

    out = dst[out_pos:]
    pos = 0
    if abs(step) > np.finfo(np.float32).eps:
        gain = current_gain
        sc = np.arange(fade_len, dtype=f32)
        out[:fade_len] = (out[:fade_len]
                          + in_samples[:fade_len].astype(f32) * (gain + step * sc)).astype(f32)
        pos = fade_len
        if fade_len < counter:
            return f32(gain + step * f32(fade_len))
    current_gain = target_gain
    if not (abs(target_gain) > GAIN_SILENCE_THRESHOLD):
        return current_gain
    out[pos:n] = (out[pos:n] + in_samples[pos:n].astype(f32) * target_gain).astype(f32)
    return current_gain


def mix(in_samples: np.ndarray, out_buffer: np.ndarray, current_gains: np.ndarray,
        target_gains: np.ndarray, counter: int, out_pos: int) -> None:
    """Mix_C multi-channel variant; current_gains updated in place."""
    for c in range(out_buffer.shape[0]):
        current_gains[c] = mix_line(in_samples, out_buffer[c], current_gains[c],
                                    target_gains[c], counter, out_pos)


# ---------------------------------------------------------------------------
# HRTF mixing (hrtfbase.h)
# ---------------------------------------------------------------------------


def apply_coeffs(accum: np.ndarray, ir_size: int, coeffs: np.ndarray,
                 left: f32, right: f32) -> None:
    """accum[i][lr] += coeffs[i][lr] * (left|right) for i < ir_size."""
    accum[:ir_size, 0] = (accum[:ir_size, 0] + coeffs[:ir_size, 0] * left).astype(f32)
    accum[:ir_size, 1] = (accum[:ir_size, 1] + coeffs[:ir_size, 1] * right).astype(f32)


def mix_hrtf(in_samples: np.ndarray, accum: np.ndarray, ir_size: int,
             coeffs: np.ndarray, delay: tuple[int, int], gain: float,
             gain_step: float, n: int) -> None:
    """MixHrtfBase: in_samples = history(64) ++ current block."""
    ldelay = HRTF_HISTORY_LENGTH - delay[0]
    rdelay = HRTF_HISTORY_LENGTH - delay[1]
    for i in range(n):
        g = f32(gain + gain_step * f32(i))
        left = f32(in_samples[ldelay + i] * g)
        right = f32(in_samples[rdelay + i] * g)
        apply_coeffs(accum[i:], ir_size, coeffs, left, right)


def mix_hrtf_blend(in_samples: np.ndarray, accum: np.ndarray, ir_size: int,
                   old_coeffs: np.ndarray, old_delay: tuple[int, int], old_gain: float,
                   new_coeffs: np.ndarray, new_delay: tuple[int, int],
                   new_gain_step: float, n: int) -> None:
    """MixHrtfBlendBase: old IR ramps out over n, new IR ramps in from 0."""
    old_gain_step = f32(old_gain / f32(n))
    if old_gain > GAIN_SILENCE_THRESHOLD:
        ldelay = HRTF_HISTORY_LENGTH - old_delay[0]
        rdelay = HRTF_HISTORY_LENGTH - old_delay[1]
        for i in range(n):
            g = f32(old_gain_step * f32(n - i))
            left = f32(in_samples[ldelay + i] * g)
            right = f32(in_samples[rdelay + i] * g)
            apply_coeffs(accum[i:], ir_size, old_coeffs, left, right)
    if f32(new_gain_step) * f32(n) > GAIN_SILENCE_THRESHOLD:
        ldelay = HRTF_HISTORY_LENGTH + 1 - new_delay[0]
        rdelay = HRTF_HISTORY_LENGTH + 1 - new_delay[1]
        for i in range(1, n):
            g = f32(new_gain_step * f32(i))
            left = f32(in_samples[ldelay + i - 1] * g)
            right = f32(in_samples[rdelay + i - 1] * g)
            apply_coeffs(accum[i:], ir_size, new_coeffs, left, right)


def fold_hrtf_accum(left_out: np.ndarray, right_out: np.ndarray,
                    accum: np.ndarray, n: int) -> None:
    """Tail of MixDirectHrtfBase: add accum into L/R and shift the carry."""
    left_out[:n] = (left_out[:n] + accum[:n, 0]).astype(f32)
    right_out[:n] = (right_out[:n] + accum[:n, 1]).astype(f32)
    accum[:HRIR_LENGTH] = accum[n : n + HRIR_LENGTH]
    accum[HRIR_LENGTH:] = 0.0  # cleared region for next block


# ---------------------------------------------------------------------------
# Biquad (core/filters/biquad.cpp:176-201)
# ---------------------------------------------------------------------------


def biquad_process(coeffs: np.ndarray, z: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Transposed direct form II; coeffs = [b0,b1,b2,a1,a2]; z mutated."""
    b0, b1, b2, a1, a2 = (f32(c) for c in coeffs)
    z1, z2 = f32(z[0]), f32(z[1])
    out = np.empty_like(src, dtype=f32)
    for i, x in enumerate(src.astype(f32)):
        y = f32(x * b0 + z1)
        z1 = f32(x * b1 - y * a1 + z2)
        z2 = f32(x * b2 - y * a2)
        out[i] = y
    z[0], z[1] = z1, z2
    return out


def biquad_set_params(kind: str, f0norm: float, gain: float, rcp_q: float) -> np.ndarray:
    """BiquadFilter::SetParams → [b0,b1,b2,a1,a2] (a0 pre-divided)."""
    gain = f32(max(gain, 0.00001))
    w0 = f32(2.0 * np.pi) * f32(min(f0norm, 0.49))
    sin_w0, cos_w0 = f32(np.sin(w0)), f32(np.cos(w0))
    alpha = f32(sin_w0 / 2.0 * rcp_q)
    if kind == "highshelf":
        sga2 = f32(2.0 * np.sqrt(gain) * alpha)
        b = [gain * ((gain + 1) + (gain - 1) * cos_w0 + sga2),
             -2 * gain * ((gain - 1) + (gain + 1) * cos_w0),
             gain * ((gain + 1) + (gain - 1) * cos_w0 - sga2)]
        a = [(gain + 1) - (gain - 1) * cos_w0 + sga2,
             2 * ((gain - 1) - (gain + 1) * cos_w0),
             (gain + 1) - (gain - 1) * cos_w0 - sga2]
    elif kind == "lowshelf":
        sga2 = f32(2.0 * np.sqrt(gain) * alpha)
        b = [gain * ((gain + 1) - (gain - 1) * cos_w0 + sga2),
             2 * gain * ((gain - 1) - (gain + 1) * cos_w0),
             gain * ((gain + 1) - (gain - 1) * cos_w0 - sga2)]
        a = [(gain + 1) + (gain - 1) * cos_w0 + sga2,
             -2 * ((gain - 1) + (gain + 1) * cos_w0),
             (gain + 1) + (gain - 1) * cos_w0 - sga2]
    elif kind == "peaking":
        b = [1 + alpha * gain, -2 * cos_w0, 1 - alpha * gain]
        a = [1 + alpha / gain, -2 * cos_w0, 1 - alpha / gain]
    elif kind == "lowpass":
        b = [(1 - cos_w0) / 2, 1 - cos_w0, (1 - cos_w0) / 2]
        a = [1 + alpha, -2 * cos_w0, 1 - alpha]
    elif kind == "highpass":
        b = [(1 + cos_w0) / 2, -(1 + cos_w0), (1 + cos_w0) / 2]
        a = [1 + alpha, -2 * cos_w0, 1 - alpha]
    elif kind == "bandpass":
        b = [alpha, 0.0, -alpha]
        a = [1 + alpha, -2 * cos_w0, 1 - alpha]
    else:
        raise ValueError(kind)
    b = [f32(x) for x in b]
    a = [f32(x) for x in a]
    return np.array([b[0] / a[0], b[1] / a[0], b[2] / a[0],
                     a[1] / a[0], a[2] / a[0]], dtype=f32)
