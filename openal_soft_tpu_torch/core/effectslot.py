"""Auxiliary effect slots (core/effectslot.h + al/auxeffectslot.cpp).

Each slot owns an ambisonic wet bus (aluInitEffectPanning,
alc/panning.cpp:1441-1452: full-order ACN channels at unit scale), an effect
engine instance, and the parameters sources read for automatic send
attenuation (room rolloff, decay time, air absorption).
"""

from __future__ import annotations

import numpy as np

from ..effects import get_effect_factory
from . import ambidefs

f32 = np.float32


class EffectSlot:
    def __init__(self, slot_id: int, context) -> None:
        self.id = slot_id
        self.context = context
        device = context.device
        self.device = device
        self.gain = 1.0
        self.aux_send_auto = True
        self.target = None            # chained slot (later phase)

        self.wet_channels = device.wet_channels
        self.wet_acn = ambidefs.INDEX_FROM_ACN[: self.wet_channels]
        self.wet_scale = np.ones(self.wet_channels, f32)

        # Send-attenuation params mirrored from the attached reverb
        # (CalcEffectSlotParams, alc/alu.cpp:575-595).
        self.room_rolloff = 0.0
        self.decay_time = 0.0
        self.air_absorption_gain_hf = 1.0

        self.effect_type = "null"
        self.effect_props: dict = {}
        self.state = get_effect_factory("null")(device)
        self.index = device.register_slot(self)
        self.props_dirty = True

    def set_effect(self, effect) -> None:
        """Attach an AL effect object (al/auxeffectslot.cpp:82 dispatch)."""
        if effect is None:
            self.effect_type = "null"
            self.effect_props = {}
        else:
            self.effect_type = effect.type
            self.effect_props = dict(effect.props)
        self.state = get_effect_factory(self.effect_type)(self.device)
        self.device.slot_effect_changed(
            self, buffer=self.effect_props.get("buffer"))
        self.props_dirty = True
        self._update_send_params()

    def set_buffer(self, buffer) -> None:
        """AL_BUFFER on a slot: the convolution impulse response
        (al/auxeffectslot.cpp:539-596)."""
        self.effect_props["buffer"] = buffer
        self.device.slot_effect_changed(self, buffer=buffer)
        self.props_dirty = True

    def set_gain(self, gain: float) -> None:
        self.gain = float(gain)
        self.props_dirty = True

    def set_props(self, **props) -> None:
        self.effect_props.update(props)
        self.props_dirty = True
        self._update_send_params()

    def _update_send_params(self) -> None:
        if self.effect_type in ("reverb", "eaxreverb"):
            p = self.effect_props
            self.room_rolloff = p.get("room_rolloff_factor", 0.0)
            self.air_absorption_gain_hf = p.get("air_absorption_gain_hf", 0.994)
            if self.aux_send_auto:
                self.decay_time = p.get("decay_time", 1.49)
            else:
                self.decay_time = 0.0
        else:
            self.room_rolloff = 0.0
            self.decay_time = 0.0
            self.air_absorption_gain_hf = 1.0

    def compute_update(self) -> dict:
        """Host half of the update: props → device params dict."""
        return self.state.update(self, self.effect_props)
