"""Echo effect (alc/effects/echo.cpp; port of effects/echo.py).

Two-tap ping-pong delay with damped feedback.  The sequential form writes
``delay[o] = in + damp(delay[o - D2]) * feedback`` one sample at a time;
the block solves the same recurrence by fixed-point passes: the tap-2
stream depends on this block's writes only at lags >= D2, so ceil(T/D2)
passes of (read, damp-filter, scale) reproduce the sequential result
exactly.  Each pass's highshelf is one call of the biquad kernel from the
same filter state; the pass count is host-known (``update``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ambidefs, panning
from ..ops import spec
from .base import DelayRing, EffectState, biquad_fixed, effect_mix, register

f32 = np.float32

MAX_DELAY = 0.207
MAX_LR_DELAY = 0.404
LOWPASS_FREQ_REF = 5000.0
_SQRT2 = f32(np.sqrt(np.float32(2.0)))


@register("echo")
class EchoEffect(EffectState):
    defaults = {"delay": 0.1, "lr_delay": 0.1, "damping": 0.5,
                "feedback": 0.5, "spread": -1.0}

    _n_passes = 16  # overwritten per-config in update()

    def device_update(self, buffer=None) -> dict:
        freq = self.device.sample_rate
        dev = self.device.torch_device
        maxlen = DelayRing.length_for(
            int(MAX_DELAY * freq + 0.5) + int(MAX_LR_DELAY * freq + 0.5), 1024)
        st = DelayRing.init(maxlen, 1, dev)
        st["filter_z"] = torch.zeros((1, 2), dtype=torch.float32, device=dev)
        st["gain_cur"] = torch.zeros((2, self.device.n_dry),
                                     dtype=torch.float32, device=dev)
        return st

    def update(self, slot, props) -> dict:
        dev = self.device
        freq = f32(dev.sample_rate)
        d1 = max(int(np.rint(f32(props["delay"]) * freq)), 1)
        d2 = int(np.rint(f32(props["lr_delay"]) * freq)) + d1
        # Exact convergence needs ceil(T/d2) passes for the largest block.
        self._n_passes = max(1, -(-1024 // max(d2, 1)))
        self._d1, self._d2 = d1, d2
        gainhf = f32(max(1.0 - props["damping"], 0.0625))
        coeffs = spec.biquad_set_params("highshelf",
                                        f32(LOWPASS_FREQ_REF / freq),
                                        gainhf, _SQRT2)
        x = f32(props["spread"])
        z = f32(np.sqrt(f32(1.0 - x * x)))
        pan0 = ambidefs.calc_ambi_coeffs(x, 0.0, z, 0.0)
        pan1 = ambidefs.calc_ambi_coeffs(-x, 0.0, z, 0.0)
        layout = dev.layout
        tgt = np.zeros((2, dev.n_dry), f32)
        tgt[0] = panning.compute_pan_gains(layout.dry_acn, layout.dry_scale,
                                           pan0, slot.gain)
        tgt[1] = panning.compute_pan_gains(layout.dry_acn, layout.dry_scale,
                                           pan1, slot.gain)
        return {"d1": np.int32(d1), "d2": np.int32(d2),
                "feed_gain": f32(props["feedback"]), "filter": coeffs,
                "gain_tgt": tgt}

    def process(self, state: dict, params: dict, wet, T: int):
        d1, d2 = self._d1, self._d2
        x = wet[0]
        hist2 = DelayRing.read(state, d2, T)[0]
        # The feedback stream: ring history for o < d2, this block's delay
        # line d shifted right by d2 beyond (zeros shifted in).
        head = min(d2, T)
        d = x
        for _ in range(self._n_passes):
            r = torch.cat([hist2[:head], d[:T - head]])
            f, z_new = biquad_fixed(r[None], state["filter_z"],
                                    params["filter"])
            d = x + f[0] * params["feed_gain"]

        DelayRing.write(state, d[None], T)
        taps = torch.cat([DelayRing.read(state, T + d1, T),
                          DelayRing.read(state, T + d2, T)])
        out, new_cur = effect_mix(taps, state["gain_cur"],
                                  params["gain_tgt"], T)
        state["filter_z"].copy_(z_new)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
