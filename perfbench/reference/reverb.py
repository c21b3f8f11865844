"""OpenAL Soft's EAX reverb (``alc/effects/reverb.cpp``) for the benchmark's
plain reference, in float64, and the IIR pieces it shares with the speaker
reference: the RBJ shelves of ``core/filters/biquad.cpp``, the band
splitter of ``core/filters/splitter.cpp``, and linear filtering by FFT.

One reverb pipeline turns the four A-format lines of a slot's input (the
B-format wet bus through ``B2A``) into four early and four late lines.
Per sample n and line l, as ``ReverbPipeline::processEarly`` and
``processLate`` compute it:

- early: e[l] = main[l, n - early_tap[l]] * gain, through the master
  high shelf (gain_hf at hf_reference) and low shelf (gain_lf at
  lf_reference), then ``Allpass4``: y = d[n - ap_off] - c x, d = x + c y;
  the reflection into the early line, out_e = refl[l, n - e_off[l]] *
  e_coeff + y with refl = ``REFLECT`` @ y; and the late input,
  ``VectorPartialScatter`` of y;
- late: the feedback read of the late line at l_off[l] (plus the
  modulation's fractional delay) through the 4-tap cubic table, times the
  line's T60 mid gain, through its T60 high and low shelves, plus the late
  input at late_tap[l] times the density gain, then the vector all-pass
  (y = d[n - ap_off] - c x, d = scatter(x + c y)); out_l = y, and the late
  line takes scatter(y reversed).

The early half is a feed-forward chain of linear filters: each filter runs
over the whole range at once by FFT from its exact frequency response.  The
late half holds the feedback loop and runs in blocks no longer than the
shortest loop lag (the all-pass and line offsets), so every read within a
block is of an earlier block; its shelves run each block as a lower-
triangular Toeplitz product plus the carried state.

A fresh pipeline (the first process after the effect is set) crossfades its
taps in over the first ``CHUNK`` samples from the zero taps of a cleared
pipeline (``mEarlyDelayTap``/``mLateDelayTap`` [0], coefficient 0), as
``ReverbState::process`` does on its first update; a range that starts later
starts from zero state with the taps already settled.  With modulation
depth 0 and echo depth 0 the pipeline is linear and time-invariant.

Constants are copied from the places named beside them; parameters are
worked out in float32 as OpenAL Soft computes them.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
LINES = 4
CHUNK = 256                      # MAX_UPDATE_SAMPLES, reverb.cpp:52
DENSITY_SCALE = 1000.0           # reverb.cpp CalcDelayLengthMult
DECAY_GAIN = 0.001               # ReverbDecayGain, core/effects/base.h:21
MOD_DEPTH_COEFF = 0.05           # MODULATION_DEPTH_COEFF, reverb.cpp:67
DEFAULT_MOD_TIME = 0.25          # AL_EAXREVERB_DEFAULT_MODULATION_TIME
SPEED_OF_SOUND = 343.3           # SpeedOfSoundMetersPerSec, core/context.h:32
SQRT3 = float(np.sqrt(3.0))
INV_SQRT2 = float(1.0 / np.sqrt(2.0))

# reverb.cpp:88, :99, :113: B-format (ACN W Y Z X) to A-format and back.
B2A = np.array([[0.5, 0.5, 0.5, 0.5],
                [0.5, -0.5, -0.5, 0.5],
                [0.5, 0.5, -0.5, -0.5],
                [0.5, -0.5, 0.5, -0.5]])
EARLY_A2B = np.array([[0.5, 0.5, 0.5, 0.5],
                      [0.5, -0.5, 0.5, -0.5],
                      [0.5, -0.5, -0.5, 0.5],
                      [0.5, 0.5, -0.5, -0.5]])
LATE_A2B = np.array([[0.5, 0.5, 0.5, 0.5],
                     [INV_SQRT2, -INV_SQRT2, 0.0, 0.0],
                     [0.0, 0.0, -INV_SQRT2, INV_SQRT2],
                     [0.5, 0.5, -0.5, -0.5]])
# DelayLineU::writeReflected, reverb.cpp:323-343: each line less half the
# sum of all four.
REFLECT = np.eye(LINES) - 0.5

# reverb.cpp:125-192: line lengths in seconds at density 1/1000.
EARLY_TAP_LENGTHS = (0.0, 1.010676e-3, 2.126553e-3, 3.358580e-3)
EARLY_ALLPASS_LENGTHS = (4.854840e-4, 5.360178e-4, 5.918117e-4, 6.534130e-4)
EARLY_LINE_LENGTHS = (2.992520e-3, 5.456575e-3, 7.688329e-3, 9.709681e-3)
LATE_ALLPASS_LENGTHS = (8.091400e-4, 1.019453e-3, 1.407968e-3, 1.618280e-3)
LATE_LINE_LENGTHS = (9.709681e-3, 1.223343e-2, 1.689561e-2, 1.941936e-2)

DEFAULTS = {                      # AL_EAXREVERB_DEFAULT_*, include/AL/efx.h
    "density": 1.0, "diffusion": 1.0, "gain": 0.32, "gain_hf": 0.89,
    "gain_lf": 1.0, "decay_time": 1.49, "decay_hf_ratio": 0.83,
    "decay_lf_ratio": 1.0, "reflections_gain": 0.05,
    "reflections_delay": 0.007, "late_reverb_gain": 1.26,
    "late_reverb_delay": 0.011, "echo_time": 0.25, "echo_depth": 0.0,
    "modulation_time": 0.25, "modulation_depth": 0.0,
    "air_absorption_gain_hf": 0.994, "hf_reference": 5000.0,
    "lf_reference": 250.0, "room_rolloff_factor": 0.0,
    "decay_hf_limit": True,
}


# --- filters ----------------------------------------------------------------

def shelf(kind: str, f0norm, gain) -> np.ndarray:
    """``BiquadFilter::setParamsFromSlope`` with slope 1 (biquad.h, biquad.cpp
    setParams): [b0, b1, b2, a1, a2] over a0, float32 as OpenAL Soft."""
    g = F32(max(F32(gain), F32(0.001)))
    rcpq = F32(np.sqrt(F32(F32(g + F32(1.0) / g) * F32(0.0) + F32(2.0))))
    w0 = F32(F32(2.0 * np.pi) * F32(min(F32(f0norm), F32(0.49))))
    sw, cw = F32(np.sin(w0)), F32(np.cos(w0))
    alpha = F32(F32(sw / F32(2.0)) * rcpq)
    sga2 = F32(F32(F32(2.0) * F32(np.sqrt(g))) * alpha)
    one = F32(1.0)
    if kind == "highshelf":
        b = (g * ((g + one) + (g - one) * cw + sga2),
             F32(-2.0) * g * ((g - one) + (g + one) * cw),
             g * ((g + one) + (g - one) * cw - sga2))
        a = ((g + one) - (g - one) * cw + sga2,
             F32(2.0) * ((g - one) - (g + one) * cw),
             (g + one) - (g - one) * cw - sga2)
    elif kind == "lowshelf":
        b = (g * ((g + one) - (g - one) * cw + sga2),
             F32(2.0) * g * ((g - one) - (g + one) * cw),
             g * ((g + one) - (g - one) * cw - sga2))
        a = ((g + one) + (g - one) * cw + sga2,
             F32(-2.0) * ((g - one) + (g + one) * cw),
             (g + one) + (g - one) * cw - sga2)
    else:
        raise ValueError(kind)
    b = [F32(v) for v in b]
    a = [F32(v) for v in a]
    return np.array([b[0] / a[0], b[1] / a[0], b[2] / a[0], a[1] / a[0],
                     a[2] / a[0]], F32)


def biquad_response(coeffs, n_fft: int) -> np.ndarray:
    """The biquad's response [..., n_fft // 2 + 1] on the FFT's grid."""
    c = np.asarray(coeffs, np.float64)
    z = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    b0, b1, b2, a1, a2 = (c[..., i, None] for i in range(5))
    return (b0 + z * (b1 + z * b2)) / (1.0 + z * (a1 + z * a2))


def pole_radius(coeffs) -> np.ndarray:
    """The pole radius of each biquad [..., 5]."""
    c = np.asarray(coeffs, np.float64)
    a1, a2 = c[..., 3], c[..., 4]
    disc = a1 * a1 - 4.0 * a2
    root = np.sqrt(np.abs(disc))
    real = np.maximum(np.abs(-a1 + root), np.abs(-a1 - root)) / 2.0
    return np.where(disc < 0.0, np.sqrt(np.abs(a2)), real)


def span(radius: float) -> int:
    """Samples after which a response of pole ``radius`` is below 1e-18."""
    return int(np.ceil(np.log(1e-18) / np.log(max(float(radius), 1e-3))))


def splitter_coeff(f0norm) -> F32:
    """``BandSplitterR::init`` (splitter.cpp): the all-pass coefficient."""
    w = F32(F32(2.0 * np.pi) * F32(min(float(f0norm), 0.49)))
    cw = F32(np.cos(w))
    if cw > np.finfo(np.float32).eps:
        return F32((F32(np.sin(w)) - F32(1.0)) / cw)
    return F32(cw * F32(-0.5))


def splitter_responses(coeff, n_fft: int) -> tuple:
    """(low-pass, all-pass) responses of ``BandSplitterR::process``: two
    one-pole trapezoidal low-passes at lp = c/2 + 1/2, each g (1 + z^-1) /
    (1 - (1 - 2g) z^-1), and the first-order all-pass (c + z^-1) /
    (1 + c z^-1); its high band is the all-pass less the low."""
    c = float(coeff)
    g = c * 0.5 + 0.5
    z = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    one = g * (1.0 + z) / (1.0 - (1.0 - 2.0 * g) * z)
    return one * one, (c + z) / (1.0 + c * z)


def splitter_span(coeff) -> int:
    """Samples after which the splitter's response is below 1e-18 (its
    low band is a double pole)."""
    c = float(coeff)
    return 2 * span(max(abs(1.0 - 2.0 * (c * 0.5 + 0.5)), abs(c))) + 8


def fft_filter(x: np.ndarray, resp: np.ndarray, n_fft: int) -> np.ndarray:
    """x [..., L] (zero before its first sample) through the responses
    ``resp`` [..., n_fft // 2 + 1]: the first L samples of the output."""
    L = x.shape[-1]
    return np.fft.irfft(np.fft.rfft(x, n=n_fft) * resp, n=n_fft)[..., :L]


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


# --- the 4-tap cubic table of the late line's read --------------------------

def cubic_table() -> np.ndarray:
    """``gCubicTable`` (core/cubic_tables.cpp): [256 phases, 4] float32;
    the late line's read weighs its samples at lags d, d + 1, d + 2, d + 3
    past the line's offset by a phase's four weights."""
    steps = 256

    def coeff(idx):
        k = 0.5 + idx
        if k > 512.0:
            return 0.0
        s = np.sin(np.pi * 1.280 / 1024.0 * k)
        t = (np.cos(np.pi * 2.000 / 1023.0 * k) - 1.0) * 0.50
        u = (np.cos(np.pi * 4.000 / 1023.0 * k) - 1.0) * 0.08
        return s * (t + u + 1.0) / k

    tab = np.zeros((steps, 4), F32)
    for i in range(steps):
        c = [coeff(steps + i), coeff(i), coeff(steps - i),
             coeff(steps * 2 - i)]
        s = 1.0 / sum(c)
        tab[i] = [F32(v * s) for v in c]
    return tab


# --- parameters -------------------------------------------------------------

def _decay_coeff(length, decay_time) -> F32:
    """CalcDecayCoeff: the gain of ``length`` seconds of a -60 dB decay
    over ``decay_time`` seconds."""
    return F32(np.power(F32(DECAY_GAIN), F32(F32(length) / F32(decay_time))))


class Params:
    """A pipeline's parameters from the effect's properties (``ReverbState::
    update``, ``ReverbPipeline::updateDelayLine``, ``EarlyReflections::
    updateLines``, ``LateReverb::updateLines``), float32 as OpenAL Soft."""

    def __init__(self, props: dict, rate: int, slot_gain: float = 1.0):
        p = dict(DEFAULTS)
        p.update(props)
        if p["echo_depth"] != 0.0:
            raise ValueError("the reference renders no echo (echo_depth 0)")
        fr = F32(rate)
        self.rate = int(rate)
        mult = F32(max(F32(1.0), F32(np.cbrt(F32(F32(p["density"])
                                                  * F32(DENSITY_SCALE))))))
        decay = F32(p["decay_time"])
        hf_ratio = F32(p["decay_hf_ratio"])
        air = F32(p["air_absorption_gain_hf"])
        if p["decay_hf_limit"] and air < F32(1.0):
            # CalcLimitedHfRatio: the HF decay an air absorption allows.
            limit = F32(F32(1.0) / F32(SPEED_OF_SOUND) / F32(
                F32(np.log10(air)) * decay / F32(-3.0)))
            hf_ratio = F32(min(limit, hf_ratio))
        lf_decay = F32(np.clip(F32(decay * F32(p["decay_lf_ratio"])), 0.1,
                               20.0))
        hf_decay = F32(np.clip(F32(decay * hf_ratio), 0.1, 20.0))

        def samples(seconds):
            return int(F32(F32(seconds) * fr))

        self.early_taps = np.array([
            samples(F32(l) * mult + F32(p["reflections_delay"]))
            for l in EARLY_TAP_LENGTHS])
        self.late_taps = np.array([
            samples(F32((l - LATE_LINE_LENGTHS[0]) / LINES) * mult
                    + F32(p["late_reverb_delay"]))
            for l in LATE_LINE_LENGTHS])
        self.in_gain = F32(p["gain"])
        diff = F32(p["diffusion"])
        self.ap_coeff = F32(diff * diff * F32(INV_SQRT2))
        self.e_ap_off = np.array([samples(F32(l) * mult)
                                  for l in EARLY_ALLPASS_LENGTHS])
        self.e_off = np.array([samples(F32(l) * mult)
                               for l in EARLY_LINE_LENGTHS])
        self.e_coeff = _decay_coeff(
            F32(sum(EARLY_LINE_LENGTHS) / LINES) * mult, decay)

        mod_time = F32(p["modulation_time"])
        self.mod_step = max(int(np.rint(F32(F32(1 << 24) / (fr * mod_time)))),
                            1)
        mt = F32(min(mod_time, F32(DEFAULT_MOD_TIME)))
        self.mod_depth = F32(F32(MOD_DEPTH_COEFF / 4.0) * mt
                             * F32(p["modulation_depth"]) * fr)

        hf0 = F32(min(F32(p["hf_reference"]) / fr, F32(0.49)))
        lf0 = F32(min(F32(p["lf_reference"]) / fr, F32(0.49)))
        nwf = F32(fr / F32(20000.0))
        ap_avg = F32(sum(LATE_ALLPASS_LENGTHS) / LINES)
        delay_avg = F32(F32(sum(LATE_LINE_LENGTHS) / LINES) + ap_avg)
        decay_w = F32(lf0 * nwf * lf_decay + (hf0 - lf0) * nwf * decay
                      + (F32(1.0) - hf0 * nwf) * hf_decay)
        a = _decay_coeff(delay_avg * mult, decay_w)
        self.density_gain = F32(np.sqrt(F32(F32(1.0) - a * a)))
        self.l_ap_off = np.array([samples(F32(l) * mult)
                                  for l in LATE_ALLPASS_LENGTHS])
        self.l_off = np.array([max(int(F32(F32(l) * mult * fr + F32(0.5))), 1)
                               - 1 for l in LATE_LINE_LENGTHS])
        mod_delay = F32(self.mod_depth / fr)
        self.t60_mid = np.zeros(LINES, F32)
        self.t60_hf = np.zeros((LINES, 5), F32)
        self.t60_lf = np.zeros((LINES, 5), F32)
        for i, (apl, ll) in enumerate(zip(LATE_ALLPASS_LENGTHS,
                                          LATE_LINE_LENGTHS)):
            length = F32((F32(apl) + (ap_avg - F32(apl)) * diff) * mult
                         + mod_delay + F32(ll) * mult)
            mid = _decay_coeff(length, decay)
            self.t60_mid[i] = mid
            self.t60_lf[i] = shelf("lowshelf", lf0,
                                   F32(_decay_coeff(length, lf_decay) / mid))
            self.t60_hf[i] = shelf("highshelf", hf0,
                                   F32(_decay_coeff(length, hf_decay) / mid))
        t = F32(diff * F32(np.arctan(SQRT3)))
        self.mix_x = F32(np.cos(t))
        self.mix_y = F32(F32(np.sin(t)) / F32(SQRT3))
        self.master_lp = shelf("highshelf", hf0, p["gain_hf"])
        self.master_hp = shelf("lowshelf", lf0, p["gain_lf"])
        gain = F32(slot_gain)
        self.early_gain = F32(F32(p["reflections_gain"]) * gain)
        self.late_gain = F32(F32(p["late_reverb_gain"]) * gain)


def scatter(x: np.ndarray, mix_x, mix_y) -> np.ndarray:
    """``VectorPartialScatter`` (reverb.cpp) of four lines [4, ...]."""
    s0, s1, s2, s3 = x
    return np.stack([mix_x * s0 + mix_y * (s1 - s2 + s3),
                     mix_x * s1 + mix_y * (-s0 + s2 + s3),
                     mix_x * s2 + mix_y * (s0 - s1 + s3),
                     mix_x * s3 + mix_y * (-s0 - s1 - s2)])


def _delayed(x: np.ndarray, lags) -> np.ndarray:
    """Each line of x [4, L] delayed by its own lag, zero before."""
    out = np.zeros_like(x)
    for l, lag in enumerate(lags):
        lag = int(lag)
        if lag < x.shape[1]:
            out[l, lag:] = x[l, :x.shape[1] - lag]
    return out


def _block_biquads(sections: list, B: int) -> tuple:
    """Cascaded biquads per line over blocks of B samples as one linear
    step: y = T x + O s, s' = F x + A s, from each section's TDF2
    recurrence (y = b0 x + s1, s1' = b1 x - a1 y + s2, s2' = b2 x - a2 y).
    ``sections``: [lines, 5] coefficient arrays in cascade order.  Returns
    (T [lines, B, B], O [lines, B, 2k], F [lines, 2k, B], A [lines, 2k,
    2k]) in float64."""
    n = len(sections[0])
    T = np.broadcast_to(np.eye(B), (n, B, B)).copy()
    O = np.zeros((n, B, 0))
    F = np.zeros((n, 0, B))
    A = np.zeros((n, 0, 0))
    for sec in sections:
        t1 = np.zeros((n, B, B))
        o1 = np.zeros((n, B, 2))
        f1 = np.zeros((n, 2, B))
        a1 = np.zeros((n, 2, 2))
        for l, (b0, b1, b2, c1, c2) in enumerate(np.asarray(sec, np.float64)):
            M = np.array([[-c1, 1.0], [-c2, 0.0]])
            v = np.array([b1 - c1 * b0, b2 - c2 * b0])
            h = np.zeros(B)
            h[0] = b0
            pw = np.eye(2)
            for k in range(B):
                o1[l, k] = pw[0]                   # C M^k, C = [1, 0]
                if k + 1 < B:
                    h[k + 1] = (pw @ v)[0]
                pw = M @ pw
            for i in range(B):
                t1[l, i, :i + 1] = h[i::-1]
            pw = np.eye(2)
            for j in range(B - 1, -1, -1):
                f1[l, :, j] = pw @ v
                pw = M @ pw
            a1[l] = pw
        # Append the section: its input is the cascade's output so far.
        k = A.shape[1]
        A2 = np.zeros((n, k + 2, k + 2))
        A2[:, :k, :k] = A
        A2[:, k:, :k] = f1 @ O
        A2[:, k:, k:] = a1
        F = np.concatenate([F, f1 @ T], axis=1)
        O = np.concatenate([t1 @ O, o1], axis=2)
        T = t1 @ T
        A = A2
    return T, O, F, A


class Pipeline:
    """One reverb pipeline over ranges of frames.  ``run(ain, n0, fresh)``
    takes the A-format input ain [4, L] of frames [n0, n0 + L), zero before
    n0, and returns (early, late) [4, L]: from the effect's first frame
    when ``fresh`` (n0 is then the first frame it processes), else from
    zero state at n0 with the taps settled."""

    def __init__(self, params: Params, dtype=np.float64) -> None:
        self.p = params
        self.dtype = dtype
        self.ctab = cubic_table().astype(np.float64)

    def _early(self, ain: np.ndarray, fresh: bool) -> tuple:
        p = self.p
        L = ain.shape[1]
        x = _delayed(ain, p.early_taps) * float(p.in_gain)
        if fresh:
            # The first chunk fades the taps in from a cleared pipeline's.
            k = min(CHUNK, L)
            x[:, :k] *= (np.arange(k, dtype=F32) * F32(1.0 / CHUNK))
        c = float(p.ap_coeff)
        tail = (8 * CHUNK + span(pole_radius(p.master_lp))
                + span(pole_radius(p.master_hp))
                + (span(c) * int(max(p.e_ap_off)) if c > 0.0 else 0))
        n_fft = next_pow2(L + tail)
        k = np.arange(n_fft // 2 + 1, dtype=np.int64)
        resp = (biquad_response(p.master_lp, n_fft)
                * biquad_response(p.master_hp, n_fft))
        ap = []
        for off in p.e_ap_off:
            zo = np.exp((-2j * np.pi / n_fft) * ((k * int(off)) % n_fft))
            ap.append((zo - c) / (1.0 - c * zo))
        y = fft_filter(x, resp[None, :] * np.stack(ap), n_fft).astype(
            self.dtype)
        refl = REFLECT.astype(self.dtype) @ y
        early = _delayed(refl, p.e_off) * self.dtype(p.e_coeff) + y
        late_in = scatter(y, self.dtype(p.mix_x), self.dtype(p.mix_y))
        return early, late_in

    def _late_input(self, late_in: np.ndarray, fresh: bool) -> np.ndarray:
        p = self.p
        dg = F32(p.density_gain)
        lin = _delayed(late_in, p.late_taps) * self.dtype(dg)
        if fresh:
            # The first chunk crossfades from the cleared taps (lag 0).
            k = min(CHUNK, late_in.shape[1])
            i = np.arange(k, dtype=F32)
            step = F32(dg * F32(1.0 / CHUNK))
            lin[:, :k] = (late_in[:, :k] * (dg - step * i)
                          + _delayed(late_in, p.late_taps)[:, :k] * (step * i))
        return lin

    def _lfo_delays(self, n: np.ndarray) -> tuple:
        """The modulation's read offset (whole samples, cubic phase) at the
        absolute frames n, float32 as OpenAL Soft's LFO."""
        p = self.p
        idx = (n.astype(np.uint64) * np.uint64(p.mod_step)) & np.uint64(
            0xFFFFFFFF)
        xm = (idx & np.uint64(0xFFFFFF)).astype(F32) * F32(1.0 / (1 << 24))
        first = (idx & np.uint64(1 << 23)) == 0
        lfo = np.where(first, (F32(-16.0) * xm) * xm + F32(8.0) * xm,
                       (F32(16.0) * xm) * xm - F32(24.0) * xm + F32(8.0))
        idelay = ((lfo.astype(F32) + F32(1.0)) * F32(p.mod_depth * F32(256.0))
                  ).astype(np.int64)
        return idelay >> 8, idelay & 255

    def run(self, ain: np.ndarray, n0: int, fresh: bool) -> tuple:
        p, dt = self.p, self.dtype
        ain = np.asarray(ain, dt)
        L = ain.shape[1]
        early, late_in = self._early(ain, fresh)
        lin = self._late_input(late_in, fresh)

        lap = np.asarray(p.l_ap_off, np.int64)
        loff = np.asarray(p.l_off, np.int64)
        B = int(min(lap.min(), loff.min(), CHUNK))
        if B < 1:
            raise ValueError("a late line shorter than a sample")
        T, O, F, A = (m.astype(dt) for m in _block_biquads(
            [p.t60_hf, p.t60_lf], B))
        mid = p.t60_mid.astype(np.float64)[:, None, None]
        T, F = (T * mid).astype(dt), (F * mid.transpose(0, 2, 1)).astype(dt)
        state = np.zeros((LINES, A.shape[1], 1), dt)
        mod = p.mod_depth > 0.0
        pad = int(loff.max() + lap.max() + 8
                  + (int(p.mod_depth * 2.0) + 2 if mod else 0))
        n_blocks = -(-L // B)
        total = pad + n_blocks * B
        line = np.zeros((LINES, total), dt)     # the late feedback line
        vap = np.zeros((LINES, total), dt)      # the vector all-pass line
        flat_line, flat_vap = line.reshape(-1), vap.reshape(-1)
        lin = np.concatenate([lin, np.zeros((LINES, n_blocks * B - L), dt)],
                             axis=1)
        late = np.zeros((LINES, n_blocks * B), dt)
        c = dt(p.ap_coeff)
        mx, my = dt(p.mix_x), dt(p.mix_y)
        S = scatter(np.eye(LINES), mx, my).astype(dt)     # scatter as a matrix
        S_rev = S[:, ::-1].copy()
        rows = np.arange(LINES)[:, None, None] * total
        taps = np.arange(4)[None, None, :]
        j0 = np.arange(B)[None, :, None]
        at_acc = rows + pad + j0 - loff[:, None, None] - taps    # [4, B, 4]
        at_vap = (rows + pad + j0 - lap[:, None, None])[:, :, 0]  # [4, B]
        w0 = self.ctab[0].astype(dt)
        for k in range(n_blocks):
            o = k * B
            if mod:
                whole, frac = self._lfo_delays(n0 + o + np.arange(B))
                w = self.ctab[frac].astype(dt)                      # [B, 4]
                acc = (flat_line[at_acc + o - whole[None, :, None]]
                       * w[None]).sum(-1)
            else:
                acc = flat_line[at_acc + o] @ w0
            x = acc[:, :, None]
            t = (T @ x + O @ state)[:, :, 0] + lin[:, o:o + B]
            state = F @ x + A @ state
            y = flat_vap[at_vap + o] - c * t
            vap[:, pad + o:pad + o + B] = S @ (t + c * y)
            late[:, o:o + B] = y
            line[:, pad + o:pad + o + B] = S_rev @ y
        return early, late[:, :L]
