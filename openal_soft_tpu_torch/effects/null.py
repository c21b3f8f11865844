"""Null effect (alc/effects/null.cpp): consumes the wet bus, outputs nothing."""

from __future__ import annotations

import torch

from .base import EffectState, register


@register("null")
class NullEffect(EffectState):
    defaults: dict = {}

    def process(self, state, params, wet, T: int):
        return (torch.zeros((self.device.n_dry, T), dtype=torch.float32,
                            device=wet.device), None, state)
