"""Distortion effect (alc/effects/distortion.cpp; port of
effects/distortion.py).

B-Format -> tetrahedral A-Format, 4x zero-stuffed oversampling, a lowpass
biquad, a three-fold rational waveshaper, a bandpass biquad, decimate,
A-Format -> B-Format.  All four lines run as one [4, 4T] batch through the
biquad kernel (each filter one section with an identity section beside
it); the waveshaper is elementwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import spec
from .base import (EffectState, ambi_mix_params, biquad_fixed, const,
                   effect_mix, register)

f32 = np.float32

_DEC = f32(0.25 / np.sqrt(3.0))
_ENC = f32(0.5 * np.sqrt(3.0))
B2A = np.array([[0.25, _DEC, _DEC, _DEC],
                [0.25, -_DEC, -_DEC, _DEC],
                [0.25, _DEC, -_DEC, -_DEC],
                [0.25, -_DEC, _DEC, -_DEC]], f32)
A2B = np.array([[1.0, 1.0, 1.0, 1.0],
                [_ENC, -_ENC, _ENC, -_ENC],
                [_ENC, -_ENC, -_ENC, _ENC],
                [_ENC, _ENC, -_ENC, -_ENC]], f32)


def _bw_rcpq(f0norm: f32, bandwidth: f32) -> f32:
    w0 = f32(2.0 * np.pi) * f0norm
    return f32(2.0 * np.sinh(np.log(2.0) / 2.0 * bandwidth * w0 / np.sin(w0)))


@register("distortion")
class DistortionEffect(EffectState):
    defaults = {"edge": 0.2, "gain": 0.05, "lowpass_cutoff": 8000.0,
                "eq_center": 3600.0, "eq_bandwidth": 3600.0}

    def device_update(self, buffer=None) -> dict:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=self.device.torch_device)
        return {"lp_z": z(4, 2), "bp_z": z(4, 2),
                "gain_cur": z(4, self.device.n_dry)}

    def update(self, slot, props) -> dict:
        freq = f32(self.device.sample_rate)
        edge = f32(min(np.sin(np.pi * 0.5 * f32(props["edge"])), 0.99))
        edge_coeff = f32(2.0 * edge / (1.0 - edge))

        cutoff = f32(props["lowpass_cutoff"])
        bw = f32(0.746268656716)
        lp = spec.biquad_set_params(
            "lowpass", f32(cutoff / freq * 0.25), f32(1.0),
            _bw_rcpq(f32(cutoff / freq * 0.25), bw))
        center = f32(props["eq_center"])
        bw = f32(props["eq_bandwidth"] / (center * 0.67))
        bp = spec.biquad_set_params(
            "bandpass", f32(center / freq * 0.25), f32(1.0),
            _bw_rcpq(f32(center / freq * 0.25), bw))
        _, gains = ambi_mix_params(self.device, f32(slot.gain * props["gain"]))
        return {"edge_coeff": edge_coeff, "lp": lp, "bp": bp,
                "gain_tgt": gains[:4]}

    def process(self, state, params, wet, T: int):
        a_in = torch.matmul(const(B2A, wet.device), wet[:4])

        # 4x oversample by zero stuffing (x4 gain on the impulses).
        up = torch.zeros((4, T * 4), dtype=torch.float32, device=wet.device)
        up[:, ::4] = a_in * 4.0
        y, lp_z = biquad_fixed(up, state["lp_z"], params["lp"])

        # Waveshaper folds (distortion.cpp:239-244): +(1+fc), -(1+fc), +(1+fc)
        fc = params["edge_coeff"]
        y = (1.0 + fc) * y / (1.0 + fc * y.abs())
        y = (-1.0 - fc) * y / (1.0 + fc * y.abs())
        y = (1.0 + fc) * y / (1.0 + fc * y.abs())
        y, bp_z = biquad_fixed(y, state["bp_z"], params["bp"])

        b_out = torch.matmul(const(A2B, wet.device), y[:, ::4])
        out, new_cur = effect_mix(b_out, state["gain_cur"],
                                  params["gain_tgt"], T)
        state["lp_z"].copy_(lp_z)
        state["bp_z"].copy_(bp_z)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
