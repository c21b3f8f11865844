"""4-band equalizer (alc/effects/equalizer.cpp; port of effects/equalizer.py):
low shelf, two peaking bands and a high shelf chained per wet channel, as
one four-section call of the biquad kernel (the mode of the UHJ all-pass
cascades); per-channel gains map the wet bus onto the dry bus by matching
ACN index (setAmbiMixParams)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spec
from .base import (EffectState, ambi_mix_params, biquad_fixed4, effect_mix,
                   register)

f32 = np.float32


@register("equalizer")
class EqualizerEffect(EffectState):
    defaults = {"low_gain": 1.0, "low_cutoff": 200.0,
                "mid1_gain": 1.0, "mid1_center": 500.0, "mid1_width": 1.0,
                "mid2_gain": 1.0, "mid2_center": 3000.0, "mid2_width": 1.0,
                "high_gain": 1.0, "high_cutoff": 6000.0}

    def device_update(self, buffer=None) -> dict:
        B = self.device.wet_channels
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=self.device.torch_device)
        return {"z": z(4, B, 2), "gain_cur": z(B, self.device.n_dry)}

    def update(self, slot, props) -> dict:
        freq = f32(self.device.sample_rate)

        def slope_q(gain, slope):
            return f32(np.sqrt(f32((gain + f32(1.0) / gain)
                                   * f32(1.0 / slope - 1.0) + f32(2.0))))

        def bw_q(f0norm, bw):
            w0 = f32(2.0 * np.pi) * f0norm
            return f32(2.0 * np.sinh(np.log(2.0) / 2.0 * bw * w0 / np.sin(w0)))

        g = f32(np.sqrt(f32(props["low_gain"])))
        c0 = spec.biquad_set_params("lowshelf", f32(props["low_cutoff"] / freq),
                                    g, slope_q(g, 0.75))
        g = f32(np.sqrt(f32(props["mid1_gain"])))
        f0 = f32(props["mid1_center"] / freq)
        c1 = spec.biquad_set_params("peaking", f0, g,
                                    bw_q(f0, f32(props["mid1_width"])))
        g = f32(np.sqrt(f32(props["mid2_gain"])))
        f0 = f32(props["mid2_center"] / freq)
        c2 = spec.biquad_set_params("peaking", f0, g,
                                    bw_q(f0, f32(props["mid2_width"])))
        g = f32(np.sqrt(f32(props["high_gain"])))
        c3 = spec.biquad_set_params("highshelf",
                                    f32(props["high_cutoff"] / freq),
                                    g, slope_q(g, 0.75))

        _, gains = ambi_mix_params(self.device, slot.gain)
        return {"filters": np.stack([c0, c1, c2, c3]), "gain_tgt": gains}

    def process(self, state, params, wet, T: int):
        y, z2 = biquad_fixed4(wet, state["z"].permute(1, 0, 2),
                              params["filters"])
        state["z"].copy_(z2.permute(1, 0, 2))
        out, new_cur = effect_mix(y, state["gain_cur"], params["gain_tgt"], T)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
