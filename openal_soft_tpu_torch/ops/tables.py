"""Resampler filter tables.

Regenerates, in numpy float64 (cast to float32 at the end, like the C++ which
computes in double and narrows), the filter tables the reference builds at
startup:

* SNES-inspired Gaussian 4-tap table      (core/cubic_tables.cpp:26-72)
* Catmull-Rom spline 4-tap table          (core/cubic_tables.cpp:74-106)
* Kaiser-windowed band-limited sinc (bsinc12/24/48) phase/scale tables
                                          (core/bsinc_tables.cpp:115-371)

Beyond the reference's flat layout, this module also provides dense
``[scale, phase, tap]`` tensors padded to the unified 48-tap gather window
used by the batched TPU resampler (see ops/resample.py), plus the per-voice
``bsinc_prepare`` scale-selection math (alc/alu.cpp BsincPrepare).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..constants import (
    BSINC_PHASE_COUNT,
    BSINC_SCALE_COUNT,
    CUBIC_PHASE_COUNT,
    MIXER_FRAC_ONE,
    RESAMPLE_TAPS,
    Resampler,
)

# ---------------------------------------------------------------------------
# 4-tap tables (Gaussian / Spline)
# ---------------------------------------------------------------------------


def _snes_coeff(idx: np.ndarray) -> np.ndarray:
    """Gaussian-like coefficient curve (core/cubic_tables.cpp:27-35)."""
    k = 0.5 + idx
    s = np.sin(np.pi * 1.280 / 1024.0 * k)
    t = (np.cos(np.pi * 2.000 / 1023.0 * k) - 1.0) * 0.50
    u = (np.cos(np.pi * 4.000 / 1023.0 * k) - 1.0) * 0.08
    out = s * (t + u + 1.0) / k
    return np.where(k > 512.0, 0.0, out)


def _fill_deltas(coeffs: np.ndarray) -> np.ndarray:
    """Phase-delta rows for 4-tap tables (core/cubic_tables.cpp:58-72).

    deltas[pi] = coeffs[pi+1] - coeffs[pi]; the final phase wraps to the
    first phase shifted one tap (the leading tap delta targets 0).
    """
    n = coeffs.shape[0]
    deltas = np.empty_like(coeffs)
    deltas[: n - 1] = coeffs[1:] - coeffs[: n - 1]
    deltas[n - 1, 0] = 0.0 - coeffs[n - 1, 0]
    deltas[n - 1, 1] = coeffs[0, 0] - coeffs[n - 1, 1]
    deltas[n - 1, 2] = coeffs[0, 1] - coeffs[n - 1, 2]
    deltas[n - 1, 3] = coeffs[0, 2] - coeffs[n - 1, 3]
    return deltas


@functools.cache
def gaussian_table() -> tuple[np.ndarray, np.ndarray]:
    """(coeffs[32,4] f32, deltas[32,4] f32)."""
    index_scale = 512.0 / (CUBIC_PHASE_COUNT * 2)
    pi = np.arange(CUBIC_PHASE_COUNT, dtype=np.float64)
    c0 = _snes_coeff((CUBIC_PHASE_COUNT + pi) * index_scale)
    c1 = _snes_coeff(pi * index_scale)
    c2 = _snes_coeff((CUBIC_PHASE_COUNT - pi) * index_scale)
    c3 = _snes_coeff((CUBIC_PHASE_COUNT * 2 - pi) * index_scale)
    scale = 1.0 / (c0 + c1 + c2 + c3)
    coeffs = (np.stack([c0, c1, c2, c3], axis=1) * scale[:, None]).astype(np.float32)
    return coeffs, _fill_deltas(coeffs)


@functools.cache
def spline_table() -> tuple[np.ndarray, np.ndarray]:
    """Catmull-Rom spline (coeffs[32,4] f32, deltas[32,4] f32)."""
    third, sixth = 1.0 / 3.0, 1.0 / 6.0
    mu = np.arange(CUBIC_PHASE_COUNT, dtype=np.float64) / CUBIC_PHASE_COUNT
    mu2, mu3 = mu * mu, mu * mu * mu
    coeffs = np.stack(
        [
            -third * mu + 0.5 * mu2 - sixth * mu3,
            1.0 - 0.5 * mu - mu2 + 0.5 * mu3,
            mu + 0.5 * mu2 - 0.5 * mu3,
            -sixth * mu + sixth * mu3,
        ],
        axis=1,
    ).astype(np.float32)
    return coeffs, _fill_deltas(coeffs)


# ---------------------------------------------------------------------------
# BSinc tables
# ---------------------------------------------------------------------------


def _cyl_bessel_i0(x: float) -> float:
    """I_0(x) by the same series/termination as core/bsinc_tables.cpp:34-58."""
    x2 = x / 2.0
    term = 1.0
    total = 1.0
    k = 1
    while True:
        y = x2 / k
        k += 1
        last = total
        term *= y * y
        total += term
        if total == last:
            return total


def _sinc(x: np.ndarray) -> np.ndarray:
    out = np.sin(np.pi * x) / np.where(x == 0.0, 1.0, np.pi * x)
    eps = np.finfo(np.float64).eps
    return np.where(np.abs(x) <= eps, 1.0, out)


def _kaiser(beta: float, k: np.ndarray, i0_beta: float) -> np.ndarray:
    inside = (k >= -1.0) & (k <= 1.0)
    kk = np.where(inside, k, 0.0)
    vals = np.array([_cyl_bessel_i0(v) for v in np.atleast_1d(beta * np.sqrt(1.0 - kk * kk))])
    return np.where(inside, vals / i0_beta, 0.0)


def _kaiser_width(rejection: float, order: float) -> float:
    if rejection > 21.19:
        return (rejection - 7.95) / (2.285 * 2.0 * np.pi * order)
    return 5.79 / (2.0 * np.pi) / order


def _kaiser_beta(rejection: float) -> float:
    if rejection > 50.0:
        return 0.1102 * (rejection - 8.7)
    if rejection >= 21.0:
        return 0.5842 * (rejection - 21.0) ** 0.4 + 0.07886 * (rejection - 21.0)
    return 0.0


@dataclasses.dataclass(frozen=True)
class BSincTable:
    """One bsinc quality tier, in both flat reference layout and dense layout.

    ``flat`` matches core/bsinc_tables.cpp exactly: per scale index, 32 phases
    of (m coeffs, m phase-deltas) rows followed by 32 phases of
    (m scale-deltas, m scale-phase-deltas) rows.

    ``fil/phd/scd/spd`` are dense ``[16, 32, 48]`` f32, zero-padded into the
    unified gather window: tap j of a scale with (padded) m points lands at
    column ``j + 24 - m//2`` so that every scale reads source samples
    ``pos - 23 .. pos + 24``.
    """

    scale_base: np.float32
    scale_range: np.float32
    m: np.ndarray            # [16] padded point counts (multiples of 4)
    filter_offset: np.ndarray  # [16] offsets into flat
    flat: np.ndarray         # reference-layout flat table
    fil: np.ndarray
    phd: np.ndarray
    scd: np.ndarray
    spd: np.ndarray


def _build_bsinc(rejection: float, order: float, max_scale: float) -> BSincTable:
    beta = _kaiser_beta(rejection)
    scale_base = _kaiser_width(rejection, order) / 2.0
    scale_limit = 1.0 / max_scale
    i0_beta = _cyl_bessel_i0(beta)

    nscales, nphases = BSINC_SCALE_COUNT, BSINC_PHASE_COUNT
    base_a = (order + 1.0) / 2.0
    a = np.empty(nscales)
    m_raw = np.empty(nscales, dtype=np.uint32)
    for si in range(nscales):
        scale = scale_base + (1.0 - scale_base) * ((si + 1) / nscales)
        a[si] = min(base_a / scale, base_a * max_scale)
        m_raw[si] = int(np.ceil(a[si])) * 2

    points_max = int(m_raw[0] + 3) & ~3
    # filter[si][pi][tap], f64 working precision, zero-initialised
    filt = np.zeros((nscales, nphases, points_max))
    for si in range(nscales):
        m = int(m_raw[si])
        ell = np.floor(m * 0.5) - 1.0
        o = (points_max - m) // 2
        scale = scale_base + (1.0 - scale_base) * ((si + 1) / nscales)
        max_cutoff = (0.5 - scale_base) * scale
        width = scale_base * max(scale_limit, scale)
        cutoff2 = min(max_cutoff, (scale - width) * 0.5) * 2.0
        for pi in range(nphases):
            phase = ell + pi / nphases
            x = np.arange(m, dtype=np.float64) - phase
            filt[si, pi, o : o + m] = _kaiser(beta, x / a[si], i0_beta) * cutoff2 * _sinc(cutoff2 * x)

    # --- flat reference layout (core/bsinc_tables.cpp:255-341) ---
    m_pad = ((m_raw + 3) & ~np.uint32(3)).astype(np.int64)
    total = int(np.sum(4 * nphases * m_pad))
    flat = np.zeros(total, dtype=np.float32)
    idx = 0

    def _f32(v: float) -> np.float32:
        return np.float32(v)

    for si in range(nscales):
        m = int(m_pad[si])
        o = (points_max - m) // 2
        for pi in range(nphases):
            for i in range(m):
                flat[idx] = _f32(filt[si, pi, o + i]); idx += 1
            if pi < nphases - 1:
                for i in range(m):
                    flat[idx] = _f32(filt[si, pi + 1, o + i] - filt[si, pi, o + i]); idx += 1
            else:
                flat[idx] = _f32(0.0 - filt[si, pi, o]); idx += 1
                for i in range(1, m):
                    flat[idx] = _f32(filt[si, 0, o + i - 1] - filt[si, pi, o + i]); idx += 1
        if si < nscales - 1:
            for pi in range(nphases):
                for i in range(m):
                    flat[idx] = _f32(filt[si + 1, pi, o + i] - filt[si, pi, o + i]); idx += 1
                if pi < nphases - 1:
                    for i in range(m):
                        flat[idx] = _f32(
                            (filt[si + 1, pi + 1, o + i] - filt[si + 1, pi, o + i])
                            - (filt[si, pi + 1, o + i] - filt[si, pi, o + i])
                        ); idx += 1
                else:
                    flat[idx] = _f32(
                        (0.0 - filt[si + 1, pi, o]) - (0.0 - filt[si, pi, o])
                    ); idx += 1
                    for i in range(1, m):
                        flat[idx] = _f32(
                            (filt[si + 1, 0, o + i - 1] - filt[si + 1, pi, o + i])
                            - (filt[si, 0, o + i - 1] - filt[si, pi, o + i])
                        ); idx += 1
        else:
            idx += nphases * m * 2  # zeros already

    assert idx == total

    filter_offset = np.zeros(nscales, dtype=np.int64)
    for si in range(1, nscales):
        filter_offset[si] = filter_offset[si - 1] + m_pad[si - 1] * 4 * nphases

    # --- dense padded layout from the flat table (keeps f32 rounding identical) ---
    fil = np.zeros((nscales, nphases, RESAMPLE_TAPS), dtype=np.float32)
    phd = np.zeros_like(fil)
    scd = np.zeros_like(fil)
    spd = np.zeros_like(fil)
    for si in range(nscales):
        m = int(m_pad[si])
        col = RESAMPLE_TAPS // 2 - m // 2  # 24 - m/2
        base = int(filter_offset[si])
        for pi in range(nphases):
            row = base + 2 * pi * m
            fil[si, pi, col : col + m] = flat[row : row + m]
            phd[si, pi, col : col + m] = flat[row + m : row + 2 * m]
            row_sc = base + nphases * 2 * m + 2 * pi * m
            scd[si, pi, col : col + m] = flat[row_sc : row_sc + m]
            spd[si, pi, col : col + m] = flat[row_sc + m : row_sc + 2 * m]

    scale_range = np.float32(1.0 / (1.0 - scale_base))
    return BSincTable(
        scale_base=np.float32(scale_base),
        scale_range=scale_range,
        m=m_pad,
        filter_offset=filter_offset,
        flat=flat,
        fil=fil, phd=phd, scd=scd, spd=spd,
    )


@functools.cache
def bsinc12() -> BSincTable:
    """12-point bsinc: 11th order, 60 dB rejection, up to 2x scaling."""
    return _build_bsinc(60.0, 11.0, 2.0)


@functools.cache
def bsinc24() -> BSincTable:
    """24-point bsinc: 23rd order, 60 dB rejection, up to 2x scaling."""
    return _build_bsinc(60.0, 23.0, 2.0)


@functools.cache
def bsinc48() -> BSincTable:
    """48-point bsinc: 47th order, 80 dB rejection, no extra scaling."""
    return _build_bsinc(80.0, 47.0, 1.0)


def bsinc_table_for(resampler: Resampler) -> BSincTable:
    if resampler in (Resampler.FAST_BSINC12, Resampler.BSINC12):
        return bsinc12()
    if resampler in (Resampler.FAST_BSINC24, Resampler.BSINC24):
        return bsinc24()
    if resampler in (Resampler.FAST_BSINC48, Resampler.BSINC48):
        return bsinc48()
    raise ValueError(f"not a bsinc resampler: {resampler}")


def bsinc_prepare(table: BSincTable, increment: int) -> tuple[int, np.float32]:
    """Scale-index selection + interpolation factor (alu.cpp BsincPrepare).

    Returns (si, sf).  All arithmetic is float32 to match the reference.
    """
    si = BSINC_SCALE_COUNT - 1
    sf = np.float32(0.0)
    if increment > MIXER_FRAC_ONE:
        sf = np.float32(MIXER_FRAC_ONE) / np.float32(increment) - table.scale_base
        sf = np.maximum(
            np.float32(0.0),
            np.float32(BSINC_SCALE_COUNT) * sf * table.scale_range - np.float32(1.0),
        )
        si = int(sf)  # truncate
        sf = sf - np.float32(si)
        sf = np.float32(1.0) - np.float32(np.sqrt(np.float32(1.0) - sf * sf))
    return si, np.float32(sf)


# ---------------------------------------------------------------------------
# Unified resampler weight bank for the batched device kernel
# ---------------------------------------------------------------------------
#
# Every resampler is expressed as: weights(phase pi, sub-phase pf) =
# W0[row, pi] + pf * WD[row, pi], over the unified 48-tap window
# (source index = pos + tap - 23), where `row` encodes (resampler, bsinc
# scale index).  Full bsinc additionally blends a scale-delta pair with the
# per-voice sf:  W0 = fil + sf*scd ; WD = phd + sf*spd, so the bank keeps all
# four components.  Rows with no scale deltas have scd = spd = 0.

_ROW_POINT = 0
_ROW_LINEAR = 1
_ROW_SPLINE = 2
_ROW_GAUSSIAN = 3
_ROW_BSINC12 = 4                      # 16 rows
_ROW_BSINC24 = _ROW_BSINC12 + BSINC_SCALE_COUNT
_ROW_BSINC48 = _ROW_BSINC24 + BSINC_SCALE_COUNT
N_BANK_ROWS = _ROW_BSINC48 + BSINC_SCALE_COUNT   # 52


@functools.cache
def weight_bank() -> dict[str, np.ndarray]:
    """Global resampler weight bank.

    Returns dict with 'fil', 'phd', 'scd', 'spd' each ``[52, 32, 48]`` f32.
    """
    nphases = CUBIC_PHASE_COUNT
    shape = (N_BANK_ROWS, nphases, RESAMPLE_TAPS)
    fil = np.zeros(shape, dtype=np.float32)
    phd = np.zeros(shape, dtype=np.float32)
    scd = np.zeros(shape, dtype=np.float32)
    spd = np.zeros(shape, dtype=np.float32)

    # point: value at pos (column 23), no interpolation
    fil[_ROW_POINT, :, 23] = 1.0

    # linear: exact lerp; pf has 11 fractional bits below the 5 phase bits, so
    # w0 = 1 - (pi*2048 + frac_lo)/65536 reproduces frac*(1/65536) exactly.
    pis = np.arange(nphases, dtype=np.float32)
    fil[_ROW_LINEAR, :, 23] = 1.0 - pis / nphases
    fil[_ROW_LINEAR, :, 24] = pis / nphases
    phd[_ROW_LINEAR, :, 23] = -1.0 / nphases
    phd[_ROW_LINEAR, :, 24] = 1.0 / nphases

    # 4-tap tables read source pos-1..pos+2 → columns 22..25
    sp_c, sp_d = spline_table()
    fil[_ROW_SPLINE, :, 22:26] = sp_c
    phd[_ROW_SPLINE, :, 22:26] = sp_d
    ga_c, ga_d = gaussian_table()
    fil[_ROW_GAUSSIAN, :, 22:26] = ga_c
    phd[_ROW_GAUSSIAN, :, 22:26] = ga_d

    for row0, tab in ((_ROW_BSINC12, bsinc12()), (_ROW_BSINC24, bsinc24()),
                      (_ROW_BSINC48, bsinc48())):
        fil[row0 : row0 + BSINC_SCALE_COUNT] = tab.fil
        phd[row0 : row0 + BSINC_SCALE_COUNT] = tab.phd
        scd[row0 : row0 + BSINC_SCALE_COUNT] = tab.scd
        spd[row0 : row0 + BSINC_SCALE_COUNT] = tab.spd

    return {"fil": fil, "phd": phd, "scd": scd, "spd": spd}


def prepare_voice_resampler(resampler: Resampler, increment: int,
                            frac_start: int = 0) -> tuple[int, np.float32]:
    """Per-voice (bank_row, sf) for the device resampler.

    Mirrors PrepareResampler + the `increment == 1:1 && frac == 0 → copy`
    fast path of Voice::mix (core/voice.cpp:936-941): a unity-step,
    zero-phase voice resolves to the point row regardless of quality, which
    reproduces the reference's direct copy bit-for-bit.
    """
    if increment == MIXER_FRAC_ONE and frac_start == 0:
        return _ROW_POINT, np.float32(0.0)
    if resampler == Resampler.POINT:
        return _ROW_POINT, np.float32(0.0)
    if resampler == Resampler.LINEAR:
        return _ROW_LINEAR, np.float32(0.0)
    if resampler == Resampler.SPLINE:
        return _ROW_SPLINE, np.float32(0.0)
    if resampler == Resampler.GAUSSIAN:
        return _ROW_GAUSSIAN, np.float32(0.0)
    tab = bsinc_table_for(resampler)
    si, sf = bsinc_prepare(tab, increment)
    row0 = {
        Resampler.FAST_BSINC12: _ROW_BSINC12, Resampler.BSINC12: _ROW_BSINC12,
        Resampler.FAST_BSINC24: _ROW_BSINC24, Resampler.BSINC24: _ROW_BSINC24,
        Resampler.FAST_BSINC48: _ROW_BSINC48, Resampler.BSINC48: _ROW_BSINC48,
    }[resampler]
    if resampler in (Resampler.FAST_BSINC12, Resampler.FAST_BSINC24,
                     Resampler.FAST_BSINC48):
        sf = np.float32(0.0)  # fast variant ignores scale interpolation
    # Quantize to 24-bit fixed point so the Pallas kernel (which receives sf
    # through the scalar-prefetch int path) and the jnp path agree exactly.
    sf = np.float32(np.round(sf * (1 << 24)) / (1 << 24))
    return row0 + si, sf


def resampler_max_taps(resampler: Resampler) -> int:
    """Max gather-window taps needed by a resampler (over all increments)."""
    if resampler == Resampler.POINT:
        return 2
    if resampler == Resampler.LINEAR:
        return 2
    if resampler in (Resampler.SPLINE, Resampler.GAUSSIAN):
        return 4
    return int(bsinc_table_for(resampler).m[0])
