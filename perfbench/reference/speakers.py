"""The benchmark's plain reference for speaker scenes: mono looping voices,
pitched and filtered, panned onto a 2D ambisonic bus, sent to EAX reverb
zones, and decoded to speakers, written from OpenAL Soft's mixer semantics
(``CalcAttnSourceParams``, ``CalcPanningAndFilters``, ``Voice::mix``,
``ReverbState``, ``BFormatDec``) and from nothing of the program.

What it renders, and refuses anything else:

- the listener at the origin in its default orientation, the inverse-
  clamped distance model at its defaults, no cone, no radius, no air
  absorption, a room rolloff of 0 on every send;
- voices that start together on the device's first frame, each looping a
  mono buffer from its start: at frame n it reads 16.16 position p = n *
  step (step = round(pitch * 65536) for a buffer at the device's rate),
  through the 4-tap Catmull-Rom spline of 32 phases with its deltas
  (``core/cubic_tables.cpp``, ``Resample_<CubicTag>``) over samples
  (p >> 16) - 1 .. (p >> 16) + 2, silence before the start;
- a direct lowpass (the high shelf at 5 kHz of ``AL_FILTER_LOWPASS``) and a
  lowpass on each send, with the send feeding reverb zone s from send s.

Per voice, in float32 as OpenAL Soft computes it: the direction and
distance, the dry gain 1 / max(d, 1), the wet gain of each send (its
filter gain, times the initial-decay term 0.001^((d - 1) / (decay * c)) (1
- dry) + dry of a send to a reverb), the N3D ambisonic coefficients of the
direction, the dry bus's FuMa gains and the wet bus's ACN gains, the
shelves' coefficients.  Gains at or below -100 dB mix nothing.

The output is linear in the voices, so every frame is a sum of filtered
voices: the dry bus [5, n] (ACN W Y X V U of a 2D order-2 bus) and each
zone's wet bus (its ACN W Y Z X), the zones' reverbs (``reverb.py``) and
their output panned back onto the dry bus, then the decode.  Each voice's
filters run by FFT from their exact responses, voices in chunks, the sums
over voices as matrix products, in float64 (or, for the control, in
float32 with TF32 on).

Start-up.  The voices' filters are ``BiquadInterpFilter``s, reset by
``Voice::prepare`` (core/voice.cpp:1195) and set by ``setParams``
(core/filters/biquad.cpp:131-149), which moves a filter's coefficients to
a changed target over 256 samples in 32-sample steps
(``dualProcess``, :284-343) unless the filter is fresh, when it takes
them at once (:144-149).  The direct filter is fresh at play and snaps;
each send's filter starts at the identity and interpolates to its
target.  That the sends start as not fresh is the reading of both of the
repository's packages (``clear_row``: direct counter -1, send counter 0);
no output of OpenAL Soft's library in the repository has a filtered send
to check it by, so the cell's ``first_gap`` (call 0) rests on it: read the
other way, call 0 moves by about 1e-2 of the peak (16 voices on the CPU).
The later compared calls hardly do: what the first 256 samples leave in
the zones is 110 dB down by the second 128-block call (2.73 s, 60 dB
each 1.49 s), under 1e-7 of the peak, and 220 dB by the third.  A
zone's pipeline crossfades its taps in over its first 256 samples and its
output gains ramp from 0 over the first 1024-sample update
(``MixSamples``); voice gains take their targets at once.

Truncation.  A range [a, a + n) renders from zero state at a - W, every
voice read from frame a - W on, with W = ``WARMUP_SECONDS`` (15 s), or
from the first frame when a <= W.  What is left out is the
response to input before a - W, at least W frames old.  Its largest part is
the Bathroom zone's late reverb: the T60 shelves and the mid gain take at
least 60 dB off the loop every decay time (1.49 s at the zone's low band,
decay_lf_ratio 1; its high band decays faster), so W = 15 s is 10.07 decay
times, 604 dB below the input's level: far under 1e-12 of the output's
peak.  The other memories are shorter: the shelves of the voices' filters
(poles within 0.8 of the origin: 1e-18 in 190 samples), the band splitters
(pole 0.949 at 400 Hz: 1e-18 in 820 samples), the early all-passes (0.707
per 129-314 samples: 1e-18 in 38000 samples), and CarpetedHallway's 0.3-s
decay.  A range that starts within W of the first frame renders from the
first frame, with the start-up above.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reverb

F32 = np.float32
FRAC_BITS = 16
FRAC_ONE = 1 << FRAC_BITS
PHASE_BITS = 5                     # CubicPhaseBits, core/cubic_defs.h
PHASES = 1 << PHASE_BITS
PHASE_DIFF_BITS = FRAC_BITS - PHASE_BITS
MAX_PITCH = 10                     # MaxPitch, core/voice.h
SILENCE = 1.0e-5                   # GainSilenceThreshold, -100 dB
LOWPASS_FREQ_REF = 5000.0          # LowPassFreqRef, al/filter.h
INTERP_STEP = 32                   # BiquadInterpFilter's coefficient step
INTERP_SAMPLES = 256               # ... and its span
EFFECT_RAMP = 1024                 # BufferLineSize: MixSamples' first ramp
WARMUP_SECONDS = 15.0
FLT_MAX = float(np.finfo(np.float32).max)

# FuMa to N3D scales, core/ambidefs.h (AmbiScale::FromFuMa), ACN order.
FROM_FUMA = np.array([1.414213562, 1.732050808, 1.732050808, 1.732050808,
                      1.936491673, 1.936491673, 2.236067978, 1.936491673,
                      1.936491673], F32)
ACN_2D = np.array([0, 1, 3, 4, 8])            # AmbiIndex::FromACN2D

# X51Config, alc/panning.cpp: the built-in 2D order-2 FuMa decoder of 5.1
# (rows SL FL FC FR SR; columns W Y X V U), dual band, order gains 1.
X51_HF = np.array([
    [5.67316000e-1, 4.22920000e-1, -3.15495000e-1, -6.34490000e-2, -2.92380000e-2],
    [3.68584000e-1, 2.72349000e-1, 3.21616000e-1, 1.92645000e-1, 4.82600000e-2],
    [1.83579000e-1, 0.0, 1.99588000e-1, 0.0, 9.62820000e-2],
    [3.68584000e-1, -2.72349000e-1, 3.21616000e-1, -1.92645000e-1, 4.82600000e-2],
    [5.67316000e-1, -4.22920000e-1, -3.15495000e-1, 6.34490000e-2, -2.92380000e-2]],
    F32)
X51_LF = np.array([
    [4.90109850e-1, 3.77305010e-1, -3.73106990e-1, -1.25914530e-1, 1.45133000e-2],
    [1.49085730e-1, 3.03561680e-1, 1.53290060e-1, 2.45112480e-1, -1.50753130e-1],
    [1.37654920e-1, 0.0, 4.49417940e-1, 0.0, 2.57844070e-1],
    [1.49085730e-1, -3.03561680e-1, 1.53290060e-1, -2.45112480e-1, -1.50753130e-1],
    [4.90109850e-1, -3.77305010e-1, -3.73106990e-1, 1.25914530e-1, 1.45133000e-2]],
    F32)
# The device's 5.1 channel order (FL FR FC LFE SL SR) of each decoder row.
X51_ROWS = (4, 0, 2, 1, 5)
XOVER_HZ = 400.0                    # the speaker decoders' crossover

# AmbiScale::HFScales and HF2DScales of orders 1 and 2 by component order
# (core/ambidefs.cpp:37-55).  A first-order reverb upsampled to order 2
# scales its high band by their ratio, from the 2D table where the device
# mixes in 2D: ReverbState::deviceUpdate (effects/reverb.cpp) takes
# AmbiScale::GetHFOrderScales(1, mAmbiOrder, m2DMixing), and InitPanning
# (alc/panning.cpp) mixes in 2D behind a decoder that is not 3D, as
# X51Config is (its second field, mIs3D, false).
HF_SCALES = {1: np.array([4.000000000, 2.309401077, 1.192569588], F32),
             2: np.array([2.981423970, 2.309401077, 1.192569588], F32)}
HF_SCALES_2D = {1: np.array([2.236067977, 1.581138830, 0.9128709292], F32),
                2: np.array([1.825741858, 1.581138830, 0.9128709292], F32)}
# AmbiScale::FirstOrderUp's decoder (core/ambidefs.cpp): eight cube
# speakers at (y, z, x) = (+-1, +-1, +-1)/sqrt(3).
_CUBE = [(y, z, x) for z in (1.0, -1.0) for y in (1.0, -1.0)
         for x in (1.0, -1.0)]
_CUBE_DEC = np.array([[1.0, y, z, x] for y, z, x in _CUBE]) * 0.125


def ambi_coeffs(y, z, x) -> np.ndarray:
    """N3D ACN coefficients 0..8 of unit directions in ambisonic (y, z, x)
    (``CalcAmbiCoeffs``, core/ambidefs.h), [..., 9] float32."""
    y, z, x = (np.asarray(v, np.float64) for v in (y, z, x))
    s3 = np.sqrt(3.0)
    c = np.stack([np.ones_like(x), s3 * y, s3 * z, s3 * x,
                  3.872983346 * (x * y), 3.872983346 * (y * z),
                  1.118033989 * (3.0 * z * z - 1.0), 3.872983346 * (x * z),
                  1.936491673 * (x * x - y * y)], axis=-1)
    return c.astype(F32)


def first_order_up() -> np.ndarray:
    """``AmbiScale::FirstOrderUp`` to order 2: [4, 9] float32, the cube
    decoder times the order-2 coefficients of its speakers."""
    r = 1.0 / np.sqrt(3.0)
    enc = np.stack([ambi_coeffs(y * r, z * r, x * r).astype(np.float64)
                    for y, z, x in _CUBE])
    return (_CUBE_DEC.T @ enc).astype(F32)


def spline_table() -> tuple:
    """The Catmull-Rom spline's 32 phases (core/cubic_tables.cpp): weights
    [32, 4] of samples p - 1 .. p + 2 and their deltas to the next phase,
    float32."""
    mu = np.arange(PHASES, dtype=np.float64) / PHASES
    w = np.stack([-mu / 3.0 + 0.5 * mu * mu - mu ** 3 / 6.0,
                  1.0 - 0.5 * mu - mu * mu + 0.5 * mu ** 3,
                  mu + 0.5 * mu * mu - 0.5 * mu ** 3,
                  -mu / 6.0 + mu ** 3 / 6.0], axis=1).astype(F32)
    d = np.empty_like(w)
    d[:-1] = w[1:] - w[:-1]
    d[-1] = np.array([0.0, w[0, 0], w[0, 1], w[0, 2]], F32) - w[-1]
    return w, d


@dataclasses.dataclass
class Layout:
    """An output: the dry bus's ACN channels and their scales, the decode
    [outputs, bus] (high band, and low band when dual-band), its crossover,
    the order the zones' reverbs are upsampled to, and whether the bus is
    2D (``m2DMixing``: horizontal-only, as every built-in speaker decoder
    but the 3D ones)."""
    dry_acn: np.ndarray
    dry_scale: np.ndarray
    dec_hf: np.ndarray
    dec_lf: np.ndarray | None
    xover_hz: float
    order: int
    two_d: bool

    @classmethod
    def surround51(cls) -> "Layout":
        """The built-in dual-band 5.1 decode (``X51Config``)."""
        hf = np.zeros((6, 5), F32)
        lf = np.zeros((6, 5), F32)
        for i, r in enumerate(X51_ROWS):
            hf[r], lf[r] = X51_HF[i], X51_LF[i]
        return cls(dry_acn=ACN_2D, dry_scale=(1.0 / FROM_FUMA[ACN_2D]
                                              ).astype(F32),
                   dec_hf=hf, dec_lf=lf, xover_hz=XOVER_HZ, order=2,
                   two_d=True)


@dataclasses.dataclass
class Voices:
    """The scene's voices: ``buffers`` (mono float32 at ``buffer_rate``),
    ``voice_buffer`` [V], positions [V, 3], pitch [V], gain [V],
    direct_gain_hf [V], send_gain and send_gain_hf [V, sends]."""
    buffers: list
    voice_buffer: np.ndarray
    positions: np.ndarray
    pitch: np.ndarray
    gain: np.ndarray
    direct_gain_hf: np.ndarray
    send_gain: np.ndarray
    send_gain_hf: np.ndarray
    buffer_rate: int


def _cast(x) -> np.ndarray:
    return np.asarray(x, F32)


class Speakers:
    """The reference's render of one speaker scene.

    ``render(start, frames)`` gives output frames [start, start + frames)
    as [frames, outputs] float32; ``render_compared`` those of the compared
    calls; ``ties`` is empty (no output depends on a round-off tie).
    ``pan`` maps a voice's unit direction (x, y, z) to the direction it is
    panned at (the identity here; stereo's pair-wise warp in a test).
    """

    ties: list = []

    def __init__(self, voices: Voices, zones: list, layout: Layout,
                 rate: int, *, device="cpu", dtype=torch.float64,
                 warmup: int | None = None, pan=None) -> None:
        self.v, self.layout, self.rate = voices, layout, int(rate)
        self.device, self.dtype = torch.device(device), dtype
        self.np_dtype = np.float64 if dtype == torch.float64 else F32
        self.warmup = int(round(WARMUP_SECONDS * rate)) if warmup is None \
            else int(warmup)
        # Voices a chunk: [64, ~1M] float64 temporaries take a few GB.
        self.chunk = 64 if self.device.type == "cuda" else 16
        if layout.order > 2:
            raise ValueError("the reference pans up to second order")
        if voices.send_gain.shape[1] != len(zones):
            raise ValueError("one reverb zone per send")
        self._voice_params(pan)
        self.zones = [reverb.Params(z, rate) for z in zones]
        self._decays = [F32(z.get("decay_time", reverb.DEFAULTS["decay_time"]))
                        for z in zones]
        self._wet_gains()
        lengths = np.array([len(b) for b in voices.buffers], np.int64)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        pool = np.concatenate([np.asarray(b, F32) for b in voices.buffers])
        t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)
        self.pool = t(pool, dtype)
        vb = np.asarray(voices.voice_buffer, np.int64)
        self.base = t(starts[vb], torch.int64)[:, None]
        self.length = t(lengths[vb], torch.int64)[:, None]
        self.steps = t(self.step, torch.int64)[:, None]
        w, d = spline_table()
        self.spline_w, self.spline_d = t(w, dtype), t(d, dtype)

    # --- per-voice parameters, float32 as OpenAL Soft ------------------------

    def _voice_params(self, pan) -> None:
        v = self.v
        pos = _cast(v.positions)
        dist = np.sqrt((pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1])
                       + pos[:, 2] * pos[:, 2]).astype(F32)
        if not (dist > np.finfo(np.float32).eps).all():
            raise ValueError("a voice at the listener has no direction")
        unit = (pos / dist[:, None]).astype(F32)
        if pan is not None:
            unit = np.stack([pan(u) for u in unit]).astype(F32)
        # CalcDirectionCoeffs: ambisonic (y, z, x) = (-x, y, -z).
        self.coeffs = ambi_coeffs(-unit[:, 0], unit[:, 1], -unit[:, 2])
        clamped = np.clip(dist, F32(1.0), F32(FLT_MAX)).astype(F32)
        self.dist, self.attn = dist, (F32(1.0) / clamped).astype(F32)
        dry = np.minimum((np.clip(_cast(v.gain) * self.attn, F32(0.0),
                                  F32(1.0))).astype(F32), F32(1000.0))
        g = (self.layout.dry_scale[None, :]
             * self.coeffs[:, self.layout.dry_acn] * dry[:, None]).astype(F32)
        self.dry_gain = np.where(np.abs(g) > SILENCE, g, F32(0.0))
        hf_norm = F32(F32(LOWPASS_FREQ_REF) / F32(self.rate))
        self.direct = np.stack([reverb.shelf("highshelf", hf_norm, h)
                                for h in _cast(v.direct_gain_hf)])
        self.direct_on = _cast(v.direct_gain_hf) != F32(1.0)
        hf = _cast(v.send_gain_hf)
        self.send = np.zeros(hf.shape + (5,), F32)
        for i, s in np.ndindex(hf.shape):
            self.send[i, s] = reverb.shelf("highshelf", hf_norm, hf[i, s])
        self.send_on = _cast(v.send_gain_hf) != F32(1.0)
        # The step: pitch times the buffer's rate over the device's.
        pitch = (_cast(v.pitch) * F32(v.buffer_rate) / F32(self.rate)
                 ).astype(F32)
        step = np.rint((pitch * F32(FRAC_ONE)).astype(F32)).astype(np.int64)
        self.step = np.where(pitch > F32(MAX_PITCH), MAX_PITCH << FRAC_BITS,
                             np.maximum(step, 1))

    def _wet_gains(self) -> None:
        """Each send's gains on its zone's first-order wet bus [V, S, 4]."""
        v = self.v
        S = len(self.zones)
        wet = np.zeros((len(self.dist), S, 4), F32)
        for s in range(S):
            base = np.minimum(np.clip(_cast(v.gain), F32(0.0), F32(1.0))
                              * _cast(v.send_gain[:, s]), F32(1000.0)
                              ).astype(F32)
            # The initial decay of a send to a reverb: metres past the
            # reference distance (rolloff 1, a metre a unit) over the
            # distance sound travels in its decay time.
            far = self.dist > F32(1.0)
            metres = (self.dist - F32(1.0)).astype(F32)
            fact = (metres / F32(self._decays[s] * F32(reverb.SPEED_OF_SOUND))
                    ).astype(F32)
            decay = (np.power(F32(0.001), fact).astype(F32)
                     * (F32(1.0) - self.attn) + self.attn).astype(F32)
            base = np.where(far, (base * decay).astype(F32), base)
            g = (self.coeffs[:, :4] * base[:, None]).astype(F32)
            wet[:, s] = np.where(np.abs(g) > SILENCE, g, F32(0.0))
        self.wet_gain = wet

    # --- the voices --------------------------------------------------------

    def _samples(self, rows: slice, n0: int, count: int) -> torch.Tensor:
        """Voices ``rows`` resampled over frames [n0, n0 + count):
        [v, count]."""
        n = torch.arange(n0, n0 + count, device=self.device,
                         dtype=torch.int64)[None, :]
        pos = n * self.steps[rows]
        whole = pos >> FRAC_BITS
        frac = pos & (FRAC_ONE - 1)
        phase = frac >> PHASE_DIFF_BITS
        part = (frac & ((1 << PHASE_DIFF_BITS) - 1)).to(self.dtype) * (
            1.0 / (1 << PHASE_DIFF_BITS))
        del pos, frac
        base, length = self.base[rows], self.length[rows]
        x = torch.zeros(whole.shape, dtype=self.dtype, device=self.device)
        for k in range(4):
            j = whole + (k - 1)
            s = self.pool[base + torch.remainder(j, length)]
            s = torch.where(j >= 0, s, 0.0)
            x += (self.spline_w[phase, k] + part * self.spline_d[phase, k]) * s
            del j, s
        return x

    def _send_heads(self, count: int) -> torch.Tensor:
        """The sends' first ``count`` samples from the first frame, with
        each filter's coefficients interpolating from the identity (the
        TDF2 recurrence, sample by sample): [V, S, count]."""
        V, S = self.send.shape[:2]
        x = self._samples(slice(None), 0, count)
        tgt = self.send.reshape(V * S, 5)
        cur = np.tile(np.array([1.0, 0.0, 0.0, 0.0, 0.0], F32), (V * S, 1))
        cnt = INTERP_SAMPLES
        xs = x.repeat_interleave(S, dim=0)
        z1 = torch.zeros(V * S, dtype=self.dtype, device=self.device)
        z2 = torch.zeros_like(z1)
        out = torch.empty((V * S, count), dtype=self.dtype, device=self.device)
        for s0 in range(0, count, INTERP_STEP):
            b0, b1, b2, a1, a2 = (torch.as_tensor(cur[:, i], dtype=self.dtype,
                                                  device=self.device)
                                  for i in range(5))
            for t in range(s0, min(s0 + INTERP_STEP, count)):
                xt = xs[:, t]
                y = b0 * xt + z1
                z1, z2 = b1 * xt - a1 * y + z2, b2 * xt - a2 * y
                out[:, t] = y
            if cnt > 0:                          # the coefficients' step
                cnt = max(cnt - INTERP_STEP, 0)
                a = F32(1.0) / F32(cnt // INTERP_STEP + 1)
                cur = tgt.copy() if cnt == 0 else (cur + (tgt - cur) * a
                                                   ).astype(F32)
        on = torch.as_tensor(self.send_on.reshape(-1), device=self.device)
        out = torch.where(on[:, None], out, xs)
        return out.reshape(V, S, count)

    def _buses(self, n0: int, L: int, fresh: bool) -> tuple:
        """The dry bus [5, L] and the wet buses [S, 4, L] of frames
        [n0, n0 + L), float64 numpy (the control: float32)."""
        V, S = len(self.step), len(self.zones)
        tail = reverb.span(reverb.pole_radius(np.concatenate(
            [self.direct, self.send.reshape(-1, 5)])).max())
        n_fft = reverb.next_pow2(L + tail + 64)
        head = (INTERP_SAMPLES + tail) if fresh and S else 0
        heads = self._send_heads(min(head, L)) if head else None
        n_dry = len(self.layout.dry_acn)
        dry = torch.zeros((n_dry, L), dtype=self.dtype, device=self.device)
        wet = torch.zeros((S, 4, L), dtype=self.dtype, device=self.device)
        t = lambda a: torch.as_tensor(np.asarray(a), device=self.device)
        ctype = (torch.complex128 if self.dtype == torch.float64
                 else torch.complex64)
        z = torch.exp(torch.arange(n_fft // 2 + 1, device=self.device,
                                   dtype=torch.float64)
                      * (-2j * np.pi / n_fft)).to(ctype)

        def resp(c):
            """Each biquad's response [v, n_fft // 2 + 1]."""
            b0, b1, b2, a1, a2 = t(c).to(self.dtype).T[:, :, None]
            return (b0 + z * (b1 + z * b2)) / (1.0 + z * (a1 + z * a2))
        for r0 in range(0, V, self.chunk):
            rows = slice(r0, min(r0 + self.chunk, V))
            X = torch.fft.rfft(self._samples(rows, n0, L), n=n_fft)
            one = lambda c, on: torch.where(t(on)[:, None], resp(c), 1.0)
            y = torch.fft.irfft(X * one(self.direct[rows],
                                        self.direct_on[rows]), n=n_fft)[:, :L]
            g = t(self.dry_gain[rows]).to(self.dtype)
            dry += g.T @ y
            del y
            for s in range(S):
                w = torch.fft.irfft(X * one(self.send[rows, s],
                                            self.send_on[rows, s]),
                                    n=n_fft)[:, :L]
                if heads is not None:
                    w[:, :heads.shape[2]] = heads[rows, s]
                g = t(self.wet_gain[rows, s]).to(self.dtype)
                wet[s] += g.T @ w
                del w
            del X
        return (dry.cpu().numpy().astype(self.np_dtype),
                wet.cpu().numpy().astype(self.np_dtype))

    # --- the zones, the decode -------------------------------------------------

    def _zone_to_bus(self, params: reverb.Params, early, late,
                     fresh: bool) -> np.ndarray:
        """A zone's early and late lines panned onto the dry bus: back to
        B-format, upsampled (its high band scaled, then the first-order
        upsampler's rows) above first order, times the reflections' and
        late gains; the first update's gains ramp from 0."""
        lay = self.layout
        nd = self.np_dtype
        lines = [reverb.EARLY_A2B @ early, reverb.LATE_A2B @ late]
        if lay.order > 1:
            up = first_order_up()
            hf = HF_SCALES_2D if lay.two_d else HF_SCALES
            s = (hf[1] / hf[lay.order]).astype(F32)
            scale = np.array([s[0], s[1], s[1], s[1]], np.float64)
            L = early.shape[1]
            coeff = reverb.splitter_coeff(lay.xover_hz / self.rate)
            n_fft = reverb.next_pow2(L + reverb.splitter_span(coeff))
            lp_r, ap_r = reverb.splitter_responses(coeff, n_fft)
            lines = [reverb.fft_filter(b, (ap_r - lp_r) * scale[:, None]
                                       + lp_r, n_fft).astype(nd)
                     for b in lines]
        else:
            up = np.eye(4, 9, dtype=F32)
        out = 0.0
        for b, gain in zip(lines, (params.early_gain, params.late_gain)):
            g = (lay.dry_scale[None, :] * up[:, lay.dry_acn] * gain
                 ).astype(F32)                                  # [4, bus]
            g_hold = np.where(np.abs(g) > SILENCE, g, F32(0.0))
            part = g_hold.T.astype(nd) @ b
            if fresh:
                k = min(EFFECT_RAMP, b.shape[1])
                step = (g * F32(1.0 / EFFECT_RAMP)).astype(F32)
                ramp = np.abs(step) > np.finfo(np.float32).eps
                i = np.arange(k, dtype=F32)
                gk = np.where(ramp[:, :, None], step[:, :, None] * i,
                              g_hold[:, :, None]).astype(nd)
                part[:, :k] = np.einsum("ict,it->ct", gk, b[:, :k])
            out = out + part
        return out

    def render(self, start: int, frames: int) -> np.ndarray:
        n0 = max(0, int(start) - self.warmup)
        fresh = n0 == 0
        L = int(start) + int(frames) - n0
        dry, wet = self._buses(n0, L, fresh)
        for s, params in enumerate(self.zones):
            ain = reverb.B2A @ wet[s]
            early, late = reverb.Pipeline(params, self.np_dtype).run(
                ain, n0, fresh)
            dry = dry + self._zone_to_bus(params, early, late, fresh)
        lay = self.layout
        hold = lambda m: np.where(np.abs(m) > SILENCE, m, F32(0.0)
                                  ).astype(np.float64)
        if lay.dec_lf is None:
            out = hold(lay.dec_hf) @ dry
        else:
            coeff = reverb.splitter_coeff(lay.xover_hz / self.rate)
            n_fft = reverb.next_pow2(L + reverb.splitter_span(coeff))
            lp_r, ap_r = reverb.splitter_responses(coeff, n_fft)
            lp = reverb.fft_filter(dry, lp_r, n_fft)
            hp = reverb.fft_filter(dry, ap_r - lp_r, n_fft)
            out = hold(lay.dec_hf) @ hp + hold(lay.dec_lf) @ lp
        return np.ascontiguousarray(out[:, L - frames:].T).astype(F32)

    def render_compared(self, items: list) -> list:
        """``items``: [(start, frames, the program's output)]."""
        return [self.render(s, n) for s, n, _ in items]
