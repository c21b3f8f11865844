"""Pitch shifter (alc/effects/pshifter.cpp; port of effects/pshifter.py): a
Bernsee-style phase vocoder.

1024-point STFT, 8x overlap (128-sample hops), Hann window.  The W channel
runs the full analysis/synthesis (phase unwrap, bin shift, phase
accumulate); the other ambisonic channels are phase-locked to W
(pshifter.cpp:363-412).  The hops are a Python loop over batched torch ops
and ``torch.fft``; the FIFO position is a device scalar and the rotations
are index arithmetic on it.

The reference's order-dependent synthesis-bin accumulation (a later bin
replaces the target frequency only if its magnitude exceeds the *sum* of
magnitudes already accumulated on that synthesis bin, pshifter.cpp:308-314)
vectorizes exactly, as in the JAX package: the bin map j(k) = (k*pitch +
half) >> 16 is non-decreasing in k, so source bins form contiguous segments
and the accumulated-so-far magnitude is a segment-local exclusive prefix
sum.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import EffectState, ambi_mix_params, const, effect_mix, register
from .fshifter import hann_window, rotation

f32 = np.float32

STFT_SIZE = 1024
HALF = STFT_SIZE // 2            # 512
NBINS = HALF + 1                 # 513
OVERSAMPLE = 8
STEP = STFT_SIZE // OVERSAMPLE   # 128
FRAC_BITS = 16
FRAC_ONE = 1 << FRAC_BITS
FRAC_HALF = FRAC_ONE >> 1
NUM_LINES = 9                    # EffectMaxOrder=2 (pshifter.cpp:60-62)

_EXPECTED = f32(2.0 * np.pi / OVERSAMPLE)
_WINDOW = hann_window(STFT_SIZE)
_SCALE = f32(3.0 / OVERSAMPLE)   # pffft backward is unscaled: N * ifft
_RCP_PI = f32(1.0 / np.pi)
_PI = f32(np.pi)


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    """tmp -= qpd + qpd%2 with float2int truncation (pshifter.cpp:290-293)."""
    q = x.to(torch.int32)
    return x - (q + torch.fmod(q, 2)).to(torch.float32)


def _seg_accum(j, mag, payload, valid):
    """The reference's sequential synthesis-bin accumulation, vectorized.

    j: [..., K] int64 non-decreasing bin map; mag/payload: [..., K];
    valid: [..., K] bool.  Returns (syn_mag [..., NBINS],
    syn_payload [..., NBINS]) matching pshifter.cpp:308-314 exactly.
    """
    K = j.shape[-1]
    k = torch.arange(K, dtype=torch.int64, device=j.device)
    mag_v = torch.where(valid, mag, 0.0)
    excl = torch.cumsum(mag_v, dim=-1) - mag_v
    change = j[..., 1:] != j[..., :-1]
    edge = torch.ones_like(j[..., :1], dtype=torch.bool)
    start = torch.cat([edge, change], dim=-1)
    base = torch.cummax(torch.where(start, excl, -1.0), dim=-1).values
    win = valid & (mag > excl - base)
    big = j * 2048 + torch.where(win, k, -1)
    lastwin = torch.cummax(big, dim=-1).values - j * 2048
    final = torch.cat([change, edge], dim=-1)
    pay_w = torch.gather(payload, -1, lastwin.clamp(min=0))
    pay_w = torch.where(final & (lastwin >= 0), pay_w, 0.0)
    jc = torch.where(valid, j, NBINS)
    zeros = torch.zeros(j.shape[:-1] + (NBINS + 1,), dtype=mag.dtype,
                        device=j.device)
    syn_mag = zeros.scatter_add(-1, jc, mag_v)[..., :NBINS]
    syn_pay = zeros.scatter_add(-1, torch.where(final, jc, NBINS),
                                pay_w)[..., :NBINS]
    return syn_mag, syn_pay


@register("pitch_shifter")
class PshifterEffect(EffectState):
    defaults = {"coarse_tune": 12, "fine_tune": 0}

    def device_update(self, buffer=None) -> dict:
        n = min(self.device.wet_channels, NUM_LINES)
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=self.device.torch_device)
        return {
            "fifo": z(n, STFT_SIZE),
            "accum": z(n, STFT_SIZE),
            "pos": torch.full((), STFT_SIZE - STEP, dtype=torch.int64,
                              device=self.device.torch_device),
            "last_phase": z(NBINS),
            "sum_phase": z(NBINS),
            "gain_cur": z(n, self.device.n_dry),
        }

    def update(self, slot, props) -> dict:
        tune = int(props["coarse_tune"]) * 100 + int(props["fine_tune"])
        pitch = f32(2.0) ** (f32(tune) / f32(1200.0))
        pitch_i = np.int32(np.rint(np.clip(pitch, 0.5, 2.0) * FRAC_ONE))
        _, gains = ambi_mix_params(self.device, slot.gain)
        n = min(self.device.wet_channels, NUM_LINES)
        # The bin maps (host-known from the pitch).
        k = np.arange(NBINS, dtype=np.int64)
        j = (k * int(pitch_i) + FRAC_HALF) >> FRAC_BITS
        bin_limit = (NBINS << FRAC_BITS) - FRAC_HALF - 1
        bin_count = min(NBINS, bin_limit // int(pitch_i) + 1)
        return {"pitch": np.float32(pitch_i * (1.0 / FRAC_ONE)),
                "gain_tgt": gains[:n],
                "j": j, "w_valid": j <= HALF, "jc": np.minimum(j, HALF),
                "nw_valid": k < bin_count}

    def process(self, state, params, wet, T: int):
        n = min(wet.shape[0], NUM_LINES)
        dev = wet.device
        win, pitch = const(_WINDOW, dev), params["pitch"]
        j, w_valid = params["j"], params["w_valid"]
        k = torch.arange(NBINS, dtype=torch.int64, device=dev)
        k_phase = (k & (OVERSAMPLE - 1)).to(torch.float32) * _EXPECTED
        kf = k.to(torch.float32)
        bin_off = (k & ~(OVERSAMPLE - 1)).to(torch.float32)
        if n > 1:
            jb = params["jc"].expand(n - 1, NBINS)
            nw_valid = params["nw_valid"].expand(n - 1, NBINS)
        fifo, accum, pos = state["fifo"], state["accum"], state["pos"]
        last_phase, sum_phase = state["last_phase"], state["sum_phase"]
        step_i = torch.arange(STEP, dtype=torch.int64, device=dev)
        outs = []
        for f in range(T // STEP):
            at = pos + step_i
            outs.append(fifo[:, at])
            fifo = fifo.index_copy(1, at, wet[:n, f * STEP:(f + 1) * STEP])
            pos = (pos + STEP) & (STFT_SIZE - 1)
            fwd, back = rotation(pos, STFT_SIZE)
            X = torch.fft.rfft(fifo[:, fwd] * win, dim=-1)     # [n, NBINS]

            # W channel: full phase vocoder (pshifter.cpp:264-361).
            mag_w = X[0].abs()
            ph_w = torch.atan2(X[0].imag, X[0].real)
            tmp = (ph_w - last_phase) - k_phase
            last_phase = ph_w
            tmp = _wrap_pi(tmp * _RCP_PI) * f32(0.5 * OVERSAMPLE)
            syn_mag, syn_fb = _seg_accum(j, mag_w, (kf + tmp) * pitch,
                                         w_valid)
            tmp2 = (syn_fb - bin_off) * _EXPECTED
            sum_phase = _wrap_pi((tmp2 + sum_phase) * _RCP_PI) * _PI
            Xs = [torch.complex(syn_mag * torch.cos(sum_phase),
                                syn_mag * torch.sin(sum_phase))[None]]

            # Other channels: phase-locked to W (pshifter.cpp:363-412).
            if n > 1:
                Xo = X[1:]
                pd = torch.atan2(Xo.imag, Xo.real) - last_phase[None, :]
                syn_mag_o, syn_pd = _seg_accum(jb, Xo.abs(), pd, nw_valid)
                ph = _wrap_pi((sum_phase[None, :] + syn_pd) * _RCP_PI) * _PI
                Xs.append(torch.complex(syn_mag_o * torch.cos(ph),
                                        syn_mag_o * torch.sin(ph)))

            y = torch.fft.irfft(torch.cat(Xs), n=STFT_SIZE, dim=-1) \
                * _SCALE * win
            acc_rot = accum[:, fwd] + y
            fifo = fifo.index_copy(1, pos + step_i, acc_rot[:, :STEP])
            acc_rot[:, :STEP] = 0.0
            accum = acc_rot[:, back]

        out, new_cur = effect_mix(torch.cat(outs, 1), state["gain_cur"],
                                  params["gain_tgt"], T)
        for key, v in (("fifo", fifo), ("accum", accum), ("pos", pos),
                       ("last_phase", last_phase), ("sum_phase", sum_phase),
                       ("gain_cur", new_cur)):
            state[key].copy_(v)
        return out, None, state
