"""Offline Kaiser-windowed sinc resampler (common/polyphase_resampler.cpp).

Used where the reference uses PPhaseResampler: resampling whole HRTF sets
and convolution-reverb impulse responses to the device rate.  Same design
parameters (180 dB rejection, 0.47/0.03 cutoff/transition scaled by the
rate ratio, gain p) and the same polyphase evaluation — but evaluated as a
dense [out_len, in_len] matrix so a whole population of short IRs resamples
as one f64 matmul instead of per-sample loops.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _kaiser_beta(rejection_db: float) -> float:
    if rejection_db > 50.0:
        return 0.1102 * (rejection_db - 8.7)
    if rejection_db >= 21.0:
        return (0.5842 * (rejection_db - 21.0) ** 0.4
                + 0.07886 * (rejection_db - 21.0))
    return 0.0


def _kaiser_order(rejection_db: float, transition: float) -> int:
    w_t = 2.0 * np.pi * transition
    if rejection_db > 21.0:
        return int(math.ceil((rejection_db - 7.95) / (2.285 * w_t)))
    return int(math.ceil(5.79 / w_t))


@functools.lru_cache(maxsize=16)
def _design(rate_in: int, rate_out: int) -> tuple[int, int, int, tuple]:
    """(p, q, l, filter) per PPhaseResampler::init."""
    g = math.gcd(rate_in, rate_out)
    p, q = rate_out // g, rate_in // g
    maxpq = max(p, q)
    cutoff, width = 0.47 / maxpq, 0.03 / maxpq
    rejection = 180.0
    l = (_kaiser_order(rejection, width) + 1) // 2
    m = 2 * l + 1
    beta = _kaiser_beta(rejection)
    i0b = np.i0(beta)
    x = np.arange(m, dtype=np.float64) - l
    k = x / l
    win = np.where(np.abs(k) <= 1.0,
                   np.i0(beta * np.sqrt(np.maximum(1.0 - k * k, 0.0))) / i0b,
                   0.0)
    f = win * 2.0 * p * cutoff * np.sinc(2.0 * cutoff * x)
    return p, q, l, tuple(f)


@functools.lru_cache(maxsize=32)
def resample_matrix(in_len: int, out_len: int, rate_in: int,
                    rate_out: int) -> np.ndarray:
    """Dense [out_len, in_len] f64 operator == PPhaseResampler::process."""
    p, q, l0, f_t = _design(rate_in, rate_out)
    f = np.asarray(f_t)
    m = f.shape[0]
    W = np.zeros((out_len, in_len), np.float64)
    for i in range(out_len):
        li = l0 + i * q
        j_f = li % p
        j_s = li // p
        if j_f >= m:
            continue
        filt_len = (m - j_f - 1) // p + 1
        if j_s + 1 > in_len:
            skip = min(j_s + 1 - in_len, filt_len)
            j_f += p * skip
            j_s -= skip
            filt_len -= skip
        if filt_len <= 0 or j_s + 1 > in_len:
            continue
        n = min(j_s + 1, filt_len)
        # taps run backwards from j_s with filter stride p
        cols = j_s - np.arange(n)
        W[i, cols] = f[j_f + p * np.arange(n)]
    return W


def polyphase_resample(x: np.ndarray, rate_in: int, rate_out: int,
                       out_len: int | None = None) -> np.ndarray:
    """Resample along the last axis from rate_in to rate_out (f64).

    out_len defaults to ceil(len * rate_out / rate_in); the HRTF loader
    passes the fixed HrirLength to match the reference's same-size
    in/out processing (core/hrtf.cpp:542-560).
    """
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    if rate_in == rate_out:
        return x if out_len is None else x[..., :out_len]
    if out_len is None:
        out_len = int(math.ceil(n * rate_out / rate_in))
    W = resample_matrix(n, out_len, rate_in, rate_out)
    return x @ W.T
