"""Autowah effect (alc/effects/autowah.cpp; port of effects/autowah.py): an
envelope follower sweeps a peaking bandpass across [20, 2500] Hz per
sample; every wet channel runs through the swept filter with its own
state.

Both recurrences run on the effect_scan kernel: ``autowah_env`` follows
the W channel, torch turns the envelopes into the per-sample normalised
coefficients (cos and sin of w0, in the same library on the card and in
the plain version), and ``swept_tdf2`` filters every wet line with them."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import effect_scan as es
from .base import EffectState, ambi_mix_params, effect_mix, register

f32 = np.float32

GAIN_SCALE = 31621.0
MIN_FREQ = 20.0
MAX_FREQ = 2500.0
Q_FACTOR = 5.0


@register("autowah")
class AutowahEffect(EffectState):
    defaults = {"attack_time": 0.06, "release_time": 0.06,
                "resonance": 1000.0, "peak_gain": 11.22}

    def device_update(self, buffer=None) -> dict:
        B = self.device.wet_channels
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=self.device.torch_device)
        return {"env": z(), "z": z(B, 2), "gain_cur": z(B, self.device.n_dry)}

    def update(self, slot, props) -> dict:
        freq = f32(self.device.sample_rate)
        release = f32(np.clip(props["release_time"], 0.001, 1.0))
        _, gains = ambi_mix_params(self.device, slot.gain)
        attack = f32(np.exp(-1.0 / (f32(props["attack_time"]) * freq)))
        release = f32(np.exp(-1.0 / (release * freq)))
        peak_gain = f32(1.0 - np.log10(f32(props["peak_gain"]) / GAIN_SCALE))
        return {
            "env_prm": np.array([peak_gain, attack, release], f32),
            "res_gain": f32(np.sqrt(np.log10(f32(props["resonance"]))
                                    * 10.0 / 3.0)),
            "freq_min": f32(MIN_FREQ / freq),
            "bandwidth": f32((MAX_FREQ - MIN_FREQ) / freq),
            "gain_tgt": gains,
        }

    def process(self, state, params, wet, T: int):
        envs, env = es.autowah_env(wet[0:1].contiguous(),
                                   state["env"].reshape(1), params["env_prm"])
        state["env"].copy_(env[0])
        w0 = torch.clamp(params["bandwidth"] * envs[0] + params["freq_min"],
                         max=0.46) * (2.0 * np.pi)
        cos_w0 = torch.cos(w0)
        alpha = torch.sin(w0) * (0.5 / Q_FACTOR)

        # Swept peaking filter, per-sample coefficients (autowah.cpp:149-172):
        # b = [1+a*rg, -2cos, 1-a*rg], a = [1+a/rg, -2cos, 1-a/rg],
        # normalised by a0.
        rg = params["res_gain"]
        a0r = 1.0 / (1.0 + alpha / rg)
        b1 = -2.0 * cos_w0
        cf = torch.stack([(1.0 + alpha * rg) * a0r, b1 * a0r,
                          (1.0 - alpha * rg) * a0r, b1 * a0r,
                          (1.0 - alpha / rg) * a0r])
        y, z2 = es.swept_tdf2(wet.contiguous(), cf, state["z"])
        state["z"].copy_(z2)
        out, new_cur = effect_mix(y, state["gain_cur"], params["gain_tgt"], T)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
