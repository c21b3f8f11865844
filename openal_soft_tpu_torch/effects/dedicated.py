"""Dedicated dialog/LFE routing (alc/effects/dedicated.cpp; port of
effects/dedicated.py): the wet W channel routes at a fixed gain to one real
output channel (front center or LFE), bypassing the ambisonic bus.  On a
device without that channel the dialog plays from the front-center
direction on the dry bus and the LFE is silent; the real-output
contribution is then None."""

from __future__ import annotations

import numpy as np
import torch

from ..core import ambidefs, panning
from ..core.devformat import Channel
from .base import EffectState, effect_mix, register

f32 = np.float32


@register("dedicated_dialog")
class DedicatedDialogEffect(EffectState):
    defaults = {"gain": 1.0}
    target_channel = Channel.FRONT_CENTER

    def _real_index(self):
        return self.device.layout.channel_index.get(self.target_channel)

    def device_update(self, buffer=None) -> dict:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=self.device.torch_device)
        return {"gain_cur": z(1, self.device.n_real),
                "dry_cur": z(1, self.device.n_dry)}

    def update(self, slot, props) -> dict:
        gain = f32(slot.gain * props["gain"])
        tgt = np.zeros((1, self.device.n_real), f32)
        dry_tgt = np.zeros((1, self.device.n_dry), f32)
        idx = self._real_index()
        if idx is not None:
            tgt[0, idx] = gain
        elif self.target_channel == Channel.FRONT_CENTER:
            # No front-center speaker: play from the front-center location
            # on the main ambisonic bus (dedicated.cpp:74-91; LFE without
            # an LFE channel stays silent).
            lay = self.device.layout
            coeffs = ambidefs.calc_direction_coeffs((0.0, 0.0, -1.0))
            dry_tgt[0] = panning.compute_pan_gains(
                lay.dry_acn, lay.dry_scale, coeffs, gain)
        return {"gain_tgt": tgt, "dry_tgt": dry_tgt}

    def process(self, state, params, wet, T: int):
        dry, dry_cur = effect_mix(wet[0:1], state["dry_cur"],
                                  params["dry_tgt"], T)
        state["dry_cur"].copy_(dry_cur)
        real = None
        if self._real_index() is not None:
            real, cur = effect_mix(wet[0:1], state["gain_cur"],
                                   params["gain_tgt"], T)
            state["gain_cur"].copy_(cur)
        return dry, real, state


@register("dedicated_lfe")
class DedicatedLfeEffect(DedicatedDialogEffect):
    target_channel = Channel.LFE
