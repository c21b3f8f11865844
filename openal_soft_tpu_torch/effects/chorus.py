"""Chorus / Flanger (alc/effects/chorus.cpp; port of effects/chorus.py).

B-Format input converts to a 4-line A-Format; each line runs through a
modulated cubic-interpolated delay tap (sin or triangle LFO, the right pair
phase-displaced) with feedback at the average delay, then converts back.

The LFO delay sequences are index arithmetic ([T] vectors from the carried
LFO offset); the modulated taps read a contiguous ring window and gather;
the feedback recurrence ``buf[o] = in[o] + fb * buf[o - avgdelay]`` is
solved in closed form by log-depth geometric doubling (S_2m = S_m + fb^m *
shift(S_m, m*d)) after injecting the ring history at the block boundary,
as in the JAX package.  The average delay is host-known, so the shifts are
slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MIXER_FRAC_BITS
from .base import (DelayRing, EffectState, ambi_mix_params, const, effect_mix,
                   register)
from .reverb import _cubic_filter_table

f32 = np.float32

_DEC = f32(0.25 / np.sqrt(3.0))
_ENC = f32(0.5 * np.sqrt(3.0))
B2A = np.array([[0.25, _DEC, _DEC, _DEC],
                [0.25, _DEC, -_DEC, -_DEC],
                [0.25, -_DEC, -_DEC, _DEC],
                [0.25, -_DEC, _DEC, -_DEC]], f32)
A2B = np.array([[1.0, 1.0, 1.0, 1.0],
                [_ENC, _ENC, -_ENC, -_ENC],
                [_ENC, -_ENC, -_ENC, _ENC],
                [_ENC, -_ENC, _ENC, -_ENC]], f32)

CHORUS_MAX_DELAY = 0.016
FLANGER_MAX_DELAY = 0.004
MAX_RESAMPLER_EDGE = 24
_TABLE_BITS = 8
_TABLE_STEPS = 256
_CUBIC = _cubic_filter_table()


def _shift0(x: torch.Tensor, lag: int, T: int) -> torch.Tensor:
    """[B, T] rows shifted right by lag, zero fill."""
    if lag >= T:
        return torch.zeros_like(x)
    return torch.nn.functional.pad(x[:, :T - lag], (lag, 0))


@register("chorus")
class ChorusEffect(EffectState):
    defaults = {"waveform": 1, "rate": 1.1, "depth": 0.1, "feedback": 0.25,
                "delay": 0.016, "phase": 90}
    max_delay = max(CHORUS_MAX_DELAY, FLANGER_MAX_DELAY)

    def __init__(self, device) -> None:
        super().__init__(device)
        self._lfo_offset = 0
        self._lfo_range = 1
        self._born_clock = 0
        self._avg_delay = 0

    def device_update(self, buffer=None) -> dict:
        freq = self.device.sample_rate
        # NextPowerOf2(MaxDelay*2*freq + 1) per line (deviceUpdate).
        n = 1
        while n < int(self.max_delay * 2.0 * freq) + 1:
            n <<= 1
        self._buflen = max(n, 2048)
        self._lfo_offset = 0
        self._lfo_range = 1
        self._born_clock = getattr(self.device, "_clock_samples", 0)
        dev = self.device.torch_device
        st = DelayRing.init(self._buflen, 4, dev)
        st["lfo_ns"] = torch.zeros((), dtype=torch.int64, device=dev)
        st["gain_cur"] = torch.zeros((4, self.device.n_dry),
                                     dtype=torch.float32, device=dev)
        return st

    def update(self, slot, props) -> dict:
        freq = f32(self.device.sample_rate)
        mindelay = MAX_RESAMPLER_EDGE << _TABLE_BITS
        stepscale = f32(freq * _TABLE_STEPS)
        delay = max(int(np.rint(f32(props["delay"]) * stepscale)), mindelay)
        depth = f32(min(f32(delay) * f32(props["depth"]),
                        f32(delay - mindelay)))
        # avgdelay = (delay + MixerFracHalf) >> MixerFracBits, the
        # reference's scale mix (chorus.cpp:326); 0 for short flanger
        # delays, where the feedback becomes a same-sample gain.
        self._avg_delay = (delay + (1 << (MIXER_FRAC_BITS - 1))
                           ) >> MIXER_FRAC_BITS

        rate = f32(props["rate"])
        # Host mirror of the device's rendered-sample counter, used to keep
        # LFO phase continuous across rate changes (the reference rescales
        # mLfoOffset in place; here the params hold the phase origin).
        ns = (getattr(self.device, "_clock_samples", 0)
              - self._born_clock) % (1 << 30)
        if not rate > 0.0:
            self._lfo_offset, self._lfo_range = 0, 1
            lfo_scale, lfo_disp = f32(0.0), 0
        else:
            lfo_range = int(min(np.rint(freq / rate), 2 ** 31 / 360 - 180))
            phase_now = (self._lfo_offset + ns) % self._lfo_range
            self._lfo_offset = (phase_now * lfo_range // self._lfo_range
                                - ns) % lfo_range
            self._lfo_range = lfo_range
            if int(props["waveform"]) == 1:   # AL_CHORUS_WAVEFORM_TRIANGLE
                lfo_scale = f32(4.0 / lfo_range)
            else:                             # 0 = sinusoid
                lfo_scale = f32(2.0 * np.pi / lfo_range)
            phase = int(props["phase"])
            if phase < 0:
                phase += 360
            lfo_disp = (lfo_range * phase + 180) // 360

        _, gains = ambi_mix_params(self.device, slot.gain)
        return {
            "delay": np.int32(delay), "depth": depth,
            "feedback": f32(props["feedback"]),
            "waveform": np.int32(int(props["waveform"])),
            "lfo_scale": lfo_scale, "lfo_disp": np.int32(lfo_disp),
            "lfo_range": np.int32(self._lfo_range),
            "lfo_offset": np.int32(self._lfo_offset),
            "gain_tgt": gains[:4],
        }

    def _mod_delays(self, params, lfo_pos, T: int):
        """[2, T] modulated delays (calcTriangle/SinusoidDelays)."""
        i = torch.arange(T, dtype=torch.int64, device=lfo_pos.device)
        rng = params["lfo_range"]
        offs0 = torch.remainder(lfo_pos + i, rng)
        offs1 = torch.remainder(lfo_pos + params["lfo_disp"] + i, rng)
        norm = torch.stack([offs0, offs1]).to(torch.float32) \
            * params["lfo_scale"]
        tri = (1.0 - (2.0 - norm).abs()) * params["depth"]
        sin = torch.sin(norm) * params["depth"]
        lfo = torch.where(params["waveform"] == 1, tri, sin)
        return torch.round(lfo).to(torch.int64) + params["delay"]

    def process(self, state, params, wet, T: int):
        a_in = torch.matmul(const(B2A, wet.device), wet[:4])

        # LFO position: phase origin from params + carried sample counter.
        lfo_pos = torch.remainder(params["lfo_offset"] + state["lfo_ns"],
                                  params["lfo_range"])
        moddelays = self._mod_delays(params, lfo_pos, T)       # [2, T]

        # Feedback solve: buf[o] = in[o] + fb*buf[o-ad], via history
        # injection + geometric doubling.
        fb = params["feedback"]
        ad = self._avg_delay
        if ad == 0:
            resolved = a_in * (1.0 + fb)
        else:
            hist = DelayRing.read(state, ad, T)                # buf[o-ad]
            head = min(ad, T)
            u = a_in + torch.nn.functional.pad(fb * hist[:, :head],
                                               (0, T - head))
            m, fbm = 1, fb
            while m < 1024:
                u = u + fbm * _shift0(u, ad * m, T)
                fbm = fbm * fbm
                m <<= 1
            resolved = u
        DelayRing.write(state, resolved, T)

        # Modulated cubic taps: a window covering [-maxlag-2, T) relative
        # to this block's write start (the offset has already advanced by
        # T, hence the +T lookback).
        maxlag = self._buflen // 2
        win = DelayRing.read_window(state, maxlag + 2 + T, 0)  # [4, L]
        ctab = const(_CUBIC, wet.device)[moddelays & (_TABLE_STEPS - 1)]
        base = (maxlag + 2 - (moddelays >> _TABLE_BITS)
                + torch.arange(T, device=wet.device))          # [2, T]
        hi = win.shape[1] - 1
        pair = torch.tensor([0, 0, 1, 1], device=wet.device)
        bases, cds = base[pair], ctab[pair]                    # [4, T(, 4)]
        tap = lambda k: torch.gather(win, 1,  # noqa: E731
                                     (bases + k).clamp(0, hi))
        a_out = (tap(1) * cds[..., 0] + tap(0) * cds[..., 1]
                 + tap(-1) * cds[..., 2] + tap(-2) * cds[..., 3])

        b_out = torch.matmul(const(A2B, wet.device), a_out)
        out, new_cur = effect_mix(b_out, state["gain_cur"],
                                  params["gain_tgt"], T)
        state["lfo_ns"].copy_(torch.remainder(state["lfo_ns"] + T, 1 << 30))
        state["gain_cur"].copy_(new_cur)
        return out, None, state


@register("flanger")
class FlangerEffect(ChorusEffect):
    defaults = {"waveform": 1, "rate": 0.27, "depth": 1.0, "feedback": -0.5,
                "delay": 0.002, "phase": 0}
