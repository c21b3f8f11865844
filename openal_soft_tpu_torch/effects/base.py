"""Effect engine base and shared device helpers (port of effects/base.py).

Mirrors core/effects/base.h EffectState: deviceUpdate (state allocation at
the device rate), update (props -> parameters) and process (block DSP).
``process`` takes (state dict of tensors, params dict of tensors, wet
[B, T]) and returns (output contribution [n_out, T], extra real-output
contribution or None, state); the port updates the state tensors in place
where the JAX package returned new arrays.
"""

from __future__ import annotations

import numpy as np
import torch

f32 = np.float32

effect_registry: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        effect_registry[name] = cls
        cls.name = name
        return cls
    return deco


class EffectState:
    """Host-side effect instance bound to a slot on a device."""

    name = "base"
    granularity = 128   # block sizes must be multiples of this
    device_params: tuple | None = None   # update() keys uploaded (None: all)

    def __init__(self, device) -> None:
        self.device = device

    def max_window(self) -> int:
        """Largest per-call process() window the state supports (the fused
        super-block path feeds whole windows when every effect allows)."""
        return 1024

    # -- host half --
    def device_update(self, buffer=None) -> dict:
        """Allocate carried device state at the device rate; returns the
        initial state dict of tensors."""
        return {}

    def update(self, slot, props) -> dict:
        """props -> params dict of numpy arrays, uploaded with the config."""
        return {}

    # -- device half --
    def process(self, state: dict, params: dict, wet: torch.Tensor, T: int):
        """wet [B, T] -> (contribution [n_out, T], real extra, state)."""
        raise NotImplementedError


def ambi_mix_params(device, gainbase: float):
    """setAmbiMixParams (core/device.h:127-147): map wet-bus ambi channels
    onto dry-bus channels by matching ACN index.

    Returns (target_index [B] int32 with -1 for unmatched,
             gains [B, n_dry] f32 one-hot rows scaled by target scale * gain).
    """
    layout = device.layout
    B = device.wet_channels
    tgt_idx = np.full(B, -1, np.int32)
    gains = np.zeros((B, device.n_dry), f32)
    for i in range(B):  # wet bus is ACN-ordered with unit scale
        matches = np.nonzero(layout.dry_acn == i)[0]
        if matches.size:
            j = int(matches[0])
            tgt_idx[i] = j
            gains[i, j] = f32(layout.dry_scale[j] * f32(gainbase))
    return tgt_idx, gains


def effect_mix(taps: torch.Tensor, cur: torch.Tensor, tgt: torch.Tensor,
               T: int):
    """Effect-output mixing with whole-block gain ramps: MixSamples with
    Counter = samplesToDo (e.g. alc/effects/echo.cpp:157-159) ramps each
    gain linearly across the block, landing on the target.

    taps: [K, T] effect output lines; cur/tgt: [K, C] gains.
    Returns (out [C, T], new_cur [K, C]).
    """
    i = torch.arange(T, dtype=torch.float32, device=taps.device)
    step = (tgt - cur) * f32(1.0 / T)             # MixLine's delta rounding
    ramp_active = step.abs() > f32(1.1920929e-07)
    tgt_masked = torch.where(tgt.abs() > 1.0e-5, tgt, 0.0)
    gains = torch.where(ramp_active[:, :, None],
                        cur[:, :, None] + step[:, :, None] * i[None, None, :],
                        tgt_masked[:, :, None])
    return torch.einsum("kt,kct->ct", taps, gains), tgt
