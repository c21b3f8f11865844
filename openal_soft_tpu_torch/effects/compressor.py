"""Compressor effect (alc/effects/compressor.cpp; port of
effects/compressor.py): a simple AGC, distinct from the mastering limiter.
The envelope follows the first (W) wet channel with fixed 100 ms attack /
200 ms release multipliers, on the effect_scan kernel's
``compressor_env``; every wet channel is scaled by 1/env into the dry
bus."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels import effect_scan as es
from .base import EffectState, ambi_mix_params, register

f32 = np.float32

AMP_ENVELOPE_MIN = 0.5
AMP_ENVELOPE_MAX = 2.0
ATTACK_TIME = 0.1
RELEASE_TIME = 0.2


@register("compressor")
class CompressorEffect(EffectState):
    defaults = {"onoff": True}

    def device_update(self, buffer=None) -> dict:
        freq = float(self.device.sample_rate)
        self._attack = f32((AMP_ENVELOPE_MAX / AMP_ENVELOPE_MIN)
                           ** (1.0 / (freq * ATTACK_TIME)))
        self._release = f32((AMP_ENVELOPE_MIN / AMP_ENVELOPE_MAX)
                            ** (1.0 / (freq * RELEASE_TIME)))
        return {"env": torch.ones((), dtype=torch.float32,
                                  device=self.device.torch_device)}

    def update(self, slot, props) -> dict:
        _, gains = ambi_mix_params(self.device, slot.gain)
        return {"enabled": np.int32(bool(props.get("onoff", True))),
                "env_prm": np.array([self._attack, self._release], f32),
                "gain_tgt": gains}

    def process(self, state, params, wet, T: int):
        amp = torch.where(params["enabled"] != 0,
                          wet[0].abs().clamp(AMP_ENVELOPE_MIN,
                                             AMP_ENVELOPE_MAX),
                          torch.ones_like(wet[0]))
        gains, env = es.compressor_env(amp[None], state["env"].reshape(1),
                                       params["env_prm"])
        state["env"].copy_(env[0])
        # The reference applies the channel gains directly (no block ramp:
        # dst[i] += input[i]*mGains[i]*gain, compressor.cpp:150-160).
        g = params["gain_tgt"]
        g = torch.where(g.abs() > 1.0e-5, g, 0.0)
        return torch.matmul(g.T, wet * gains), None, state
