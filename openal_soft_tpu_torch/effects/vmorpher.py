"""Vocal morpher (alc/effects/vmorpher.cpp; port of effects/vmorpher.py):
two 4-formant filter banks (vowel A / vowel B) blended by an LFO.

Each formant is a topology-preserving-transform state variable filter
(vmorpher.cpp:109-138, band-pass output accumulated with a per-formant
gain).  The SVF recurrence is linear in (x, s1, s2), so every formant maps
onto the chunk-parallel 2-state filter (ops/filters.linear2_chunked) with
state-space matrices derived host-side in float64 from the reference's f32
(g, gain) values.  All wet-bus channels share one batched call: L =
channels * 8 filters.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import linear2_chunked
from .base import EffectState, ambi_mix_params, effect_mix, register

f32 = np.float32

_RCP_Q = 1.0 / 5.0
WAVEFORM_FRAC_BITS = 24
WAVEFORM_FRAC_ONE = 1 << WAVEFORM_FRAC_BITS
WAVEFORM_FRAC_MASK = WAVEFORM_FRAC_ONE - 1

_WAVE_HALF, _WAVE_SIN, _WAVE_TRI, _WAVE_SAW = 0, 1, 2, 3

# Soprano formant table (vmorpher.cpp:181-230): (freqs Hz, gains) per phoneme
# index A/E/I/O/U; other phonemes have no filter data (zero output).
_PHONEMES = {
    0: ((800.0, 1150.0, 2900.0, 3900.0), (1.0, 0.501187, 0.025118, 0.1)),
    1: ((350.0, 2000.0, 2800.0, 3600.0), (1.0, 0.1, 0.177827, 0.009999)),
    2: ((270.0, 2140.0, 2950.0, 3900.0), (1.0, 0.251188, 0.050118, 0.050118)),
    3: ((450.0, 800.0, 2830.0, 3800.0), (1.0, 0.281838, 0.079432, 0.079432)),
    4: ((325.0, 700.0, 2700.0, 3800.0), (1.0, 0.158489, 0.017782, 0.009999)),
}


def _formant_ss(f0norm: np.ndarray, gain: np.ndarray):
    """State-space (A [F,2,2], B [F,2], C [F,2], D [F]) for SVF band-pass
    outputs, f64 derivation from the reference's f32 coefficient values."""
    g = np.tan(np.pi * f0norm.astype(f32)).astype(f32).astype(np.float64)
    gain = gain.astype(f32).astype(np.float64)
    h = 1.0 / (1.0 + g * _RCP_Q + g * g)
    gh = g * h
    A = np.stack([
        np.stack([1.0 - 2.0 * gh * (_RCP_Q + g), -2.0 * gh], -1),
        np.stack([2.0 * g * (1.0 - gh * (_RCP_Q + g)), 1.0 - 2.0 * g * gh], -1),
    ], -2)
    B = np.stack([2.0 * gh, 2.0 * g * gh], -1)
    # y = B_bp * gain = (g*H + s1) * gain
    C = np.stack([(1.0 - gh * (_RCP_Q + g)) * gain, -gh * gain], -1)
    D = gh * gain
    return (A.astype(f32), B.astype(f32), C.astype(f32), D.astype(f32))


def _phoneme_ss(phoneme: int, frequency: float, pitch: float):
    freqs, gains = _PHONEMES.get(int(phoneme), ((0.0,) * 4, (0.0,) * 4))
    f0 = np.array([f32(f) * f32(pitch) / f32(frequency) for f in freqs])
    return _formant_ss(f0, np.asarray(gains))


@register("vocal_morpher")
class VmorpherEffect(EffectState):
    defaults = {"phoneme_a": 0, "phoneme_b": 10,
                "phoneme_a_coarse": 0, "phoneme_b_coarse": 0,
                "waveform": 0, "rate": 1.41}

    def device_update(self, buffer=None) -> dict:
        B = self.device.wet_channels
        dev = self.device.torch_device
        return {"index": torch.zeros((), dtype=torch.int64, device=dev),
                "s": torch.zeros((B * 8, 2), dtype=torch.float32, device=dev),
                "gain_cur": torch.zeros((B, self.device.n_dry),
                                        dtype=torch.float32, device=dev)}

    def update(self, slot, props) -> dict:
        freq = float(self.device.sample_rate)
        step = f32(props["rate"]) / f32(freq)
        stepi = int(np.clip(np.rint(f32(step) * WAVEFORM_FRAC_ONE),
                            0, WAVEFORM_FRAC_ONE - 1))
        if stepi == 0:
            wave = _WAVE_HALF
        elif props["waveform"] == 0:
            wave = _WAVE_SIN
        elif props["waveform"] == 1:
            wave = _WAVE_TRI
        else:
            wave = _WAVE_SAW
        pitch_a = f32(2.0) ** (f32(props["phoneme_a_coarse"]) / f32(12.0))
        pitch_b = f32(2.0) ** (f32(props["phoneme_b_coarse"]) / f32(12.0))
        ssa = _phoneme_ss(props["phoneme_a"], freq, pitch_a)
        ssb = _phoneme_ss(props["phoneme_b"], freq, pitch_b)
        # Every wet channel through all 8 formant filters: [B*8, ...].
        B = self.device.wet_channels
        tile = lambda a, b: np.tile(np.concatenate([a, b]),  # noqa: E731
                                    (B,) + (1,) * (a.ndim - 1))
        _, gains = ambi_mix_params(self.device, slot.gain)
        return {"A": tile(ssa[0], ssb[0]), "B": tile(ssa[1], ssb[1]),
                "C": tile(ssa[2], ssb[2]), "D": tile(ssa[3], ssb[3]),
                "step": np.int32(stepi), "wave": np.int32(wave),
                "gain_tgt": gains}

    def process(self, state, params, wet, T: int):
        B = wet.shape[0]
        step = params["step"].to(torch.int64)
        i = torch.arange(1, T + 1, dtype=torch.int64, device=wet.device)
        fi = ((state["index"] + i * step) & WAVEFORM_FRAC_MASK).to(
            torch.float32)
        wave = params["wave"]
        lfo = torch.where(
            wave == _WAVE_SIN,
            torch.sin(fi * f32(2.0 * np.pi / WAVEFORM_FRAC_ONE)) * 0.5 + 0.5,
            torch.where(wave == _WAVE_TRI,
                        (fi * f32(2.0 / WAVEFORM_FRAC_ONE) - 1.0).abs(),
                        torch.where(wave == _WAVE_SAW,
                                    fi * f32(1.0 / WAVEFORM_FRAC_ONE),
                                    torch.full_like(fi, 0.5))))

        y, s2 = linear2_chunked(wet.repeat_interleave(8, 0), state["s"],
                                params["A"], params["B"], params["C"],
                                params["D"])
        y = y.reshape(B, 2, 4, T).sum(2)                       # [B, vowel, T]
        blended = y[:, 0] + (y[:, 1] - y[:, 0]) * lfo[None, :]
        out, new_cur = effect_mix(blended, state["gain_cur"],
                                  params["gain_tgt"], T)
        state["index"].copy_((state["index"] + step * T) & WAVEFORM_FRAC_MASK)
        state["s"].copy_(s2)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
