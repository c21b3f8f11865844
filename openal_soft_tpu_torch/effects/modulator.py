"""Ring modulator (alc/effects/modulator.cpp; port of effects/modulator.py):
a sin/saw/square carrier multiplied onto the high-passed wet channels.  The
highpass runs on the biquad kernel (one section beside an identity
section); the carrier is index arithmetic in torch.

Held to the reference's goldens rather than to the JAX package, whose
carrier and mix differ in three places (ROADMAP C11): the sawtooth steps
2/(range-1) per sample, so that it spans [-1, 1]; the square wave's range
is rounded up to even and its threshold is index/(range-1) < 0.5; and the
output gains ramp over the first 64 samples of a block (MixSamples with
Counter = min(samplesToDo, 64)), not the whole block.

A new range rescales the carrier's index as ModulatorState::update does,
to index * range / old range in integers (the range before the square
wave's rounding to even over the old range after it), so the carrier
keeps its phase across a frequency change; the JAX package reduces the
index modulo the new range instead (ROADMAP C17)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spec
from .base import (EffectState, ambi_mix_params, biquad_fixed, effect_mix,
                   register)

f32 = np.float32

_WAVE_ONE, _WAVE_SIN, _WAVE_SAW, _WAVE_SQUARE = 0, 1, 2, 3
MIX_RAMP = 64   # samples of the output gains' ramp (modulator.cpp MixSamples)


@register("ring_modulator")
class ModulatorEffect(EffectState):
    defaults = {"frequency": 440.0, "highpass_cutoff": 800.0, "waveform": 0}

    def device_update(self, buffer=None) -> dict:
        B = self.device.wet_channels
        dev = self.device.torch_device
        return {"index": torch.zeros((), dtype=torch.int64, device=dev),
                "range": torch.ones((), dtype=torch.int64, device=dev),
                "z": torch.zeros((B, 2), dtype=torch.float32, device=dev),
                "gain_cur": torch.zeros((B, self.device.n_dry),
                                        dtype=torch.float32, device=dev)}

    def update(self, slot, props) -> dict:
        freq = f32(self.device.sample_rate)
        spc = (freq / f32(props["frequency"]) + f32(0.5)
               if props["frequency"] > 0 else 1.0)
        rng = int(np.clip(spc, 1.0, freq))
        rescale = np.int32(rng)
        if rng == 1:
            wave, scale = _WAVE_ONE, f32(0.0)
        elif props["waveform"] == 0:    # sinusoid
            wave, scale = _WAVE_SIN, f32(2.0 * np.pi / rng)
        elif props["waveform"] == 1:    # sawtooth
            wave, scale = _WAVE_SAW, f32(2.0 / (rng - 1))
        else:                            # square: an even range
            rng = (rng + 1) & ~1
            wave, scale = _WAVE_SQUARE, f32(1.0 / (rng - 1))
        fcut = f32(props["highpass_cutoff"] / freq)
        w0 = f32(2.0 * np.pi) * min(fcut, f32(0.49))
        rcpq = f32(2.0 * np.sinh(np.log(2.0) / 2.0 * 0.75 * w0 / np.sin(w0)))
        coeffs = spec.biquad_set_params("highpass", fcut, f32(1.0), rcpq)
        _, gains = ambi_mix_params(self.device, slot.gain)
        return {"range": np.int32(rng), "rescale": rescale,
                "scale": scale, "wave": np.int32(wave),
                "filter": coeffs, "gain_tgt": gains}

    def process(self, state, params, wet, T: int):
        # A JAX package's snapshot holds no range: its index lies on the
        # current one.
        old = state.setdefault("range", params["range"].to(torch.int64,
                                                            copy=True))
        index = torch.where(old == params["range"], state["index"],
                            state["index"] * params["rescale"] // old)
        i = torch.arange(T, dtype=torch.int64, device=wet.device)
        fi = torch.remainder(index + i, params["range"]).to(torch.float32)
        wave, scale = params["wave"], params["scale"]
        mod = torch.where(
            wave == _WAVE_SIN, torch.sin(fi * scale),
            torch.where(wave == _WAVE_SAW, fi * scale - 1.0,
                        torch.where(wave == _WAVE_SQUARE,
                                    (fi * scale < 0.5).to(torch.float32)
                                    * 2.0 - 1.0, torch.ones_like(fi))))
        y, z2 = biquad_fixed(wet, state["z"], params["filter"])
        out, new_cur = effect_mix(y * mod[None, :], state["gain_cur"],
                                  params["gain_tgt"], T, MIX_RAMP)
        state["index"].copy_(torch.remainder(index + T, params["range"]))
        state["range"].copy_(params["range"])
        state["z"].copy_(z2)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
