"""Frequency shifter (alc/effects/fshifter.cpp; port of
effects/fshifter.py): Hilbert transform of the wet signal in A-Format, then
single-sideband modulation per channel.

The reference runs a 1024-point discrete Hilbert transform with 4x
overlap-add (HilSize=1024, HilStep=256, Hann window) in double precision;
here, as in the JAX package, the same algorithm runs in float32 with one
batched FFT (``torch.fft``) over the four A-Format lines per 256-sample
hop.  The hops are a Python loop over batched torch ops; the FIFO position
is a device scalar and the rotations are index arithmetic on it.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import EffectState, ambi_mix_params, const, effect_mix, register

f32 = np.float32

HIL_SIZE = 1024
OVERSAMPLE = 4
HIL_STEP = HIL_SIZE // OVERSAMPLE        # 256
MIXER_FRAC_ONE = 1 << 16
MIXER_FRAC_MASK = MIXER_FRAC_ONE - 1

_SQRT3 = float(np.sqrt(3.0))
_DEC = f32(0.25 / _SQRT3)
B2A = np.array([
    [0.25,  _DEC,  _DEC,  _DEC],
    [0.25,  _DEC, -_DEC, -_DEC],
    [0.25, -_DEC, -_DEC,  _DEC],
    [0.25, -_DEC,  _DEC, -_DEC]], f32)        # rows: A0..A3; cols W,Y,Z,X
_ENC = f32(0.5 * _SQRT3)
A2B = np.array([
    [1.0,   1.0,   1.0,   1.0],
    [_ENC,  _ENC, -_ENC, -_ENC],
    [_ENC, -_ENC, -_ENC,  _ENC],
    [_ENC, -_ENC,  _ENC, -_ENC]], f32)        # rows W,Y,Z,X; cols A0..A3


def hann_window(n: int) -> np.ndarray:
    """gHannWindow<N> (common/hann_window.hpp): sin^2((i+1)*pi/(N+1)) for
    the first half, mirrored into the second half; f64 gen, f32 store."""
    half = (np.sin((np.arange(n // 2) + 1.0) * np.pi / (n + 1)) ** 2
            ).astype(f32)
    return np.concatenate([half, half[::-1]])


_WINDOW = hann_window(HIL_SIZE)
_HIL_MASK = np.zeros(HIL_SIZE // 2 + 1, f32)
_HIL_MASK[1:HIL_SIZE // 2] = 1.0


def complex_hilbert(x: torch.Tensor, mask: torch.Tensor):
    """Analytic signal of real rows [L, N] (common/alcomplex.cpp:198-214)
    as (re, im): the reference's inverse_fft -> scale positives ->
    forward_fft equals conj(ifft(s * rfft(x))) for real input, so re = x
    (through the round trip) and im = -H(x).  ``mask`` is 1 on the bins
    strictly between DC and Nyquist."""
    N = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    re = torch.fft.irfft(X, n=N, dim=-1)
    im = torch.fft.irfft(X * (1j * mask), n=N, dim=-1)
    return re, im


def rotation(pos: torch.Tensor, n: int):
    """Index vectors of jnp.roll(row, -pos) and jnp.roll(row, pos) over a
    row of n (a power of two), for a device scalar pos."""
    i = torch.arange(n, dtype=torch.int64, device=pos.device)
    return (i + pos) & (n - 1), (i - pos) & (n - 1)


@register("frequency_shifter")
class FshifterEffect(EffectState):
    defaults = {"frequency": 0.0, "left_direction": 0, "right_direction": 0}
    granularity = HIL_STEP

    def device_update(self, buffer=None) -> dict:
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=self.device.torch_device)
        dev = self.device.torch_device
        return {
            "in_fifo": z(4, HIL_SIZE),
            "out_fifo": z(2, 4, HIL_STEP),
            "accum": z(2, 4, HIL_SIZE),
            "pos": torch.full((), HIL_SIZE - HIL_STEP, dtype=torch.int64,
                              device=dev),
            "phase": torch.zeros(4, dtype=torch.int64, device=dev),
            "gain_cur": z(4, self.device.n_dry),
        }

    def update(self, slot, props) -> dict:
        rate = float(self.device.sample_rate)
        step = f32(props["frequency"]) / f32(rate)
        stepi = int(np.rint(min(float(step), 1.0) * MIXER_FRAC_ONE))
        steps = np.full(4, stepi, np.int32)
        signs = np.ones(4, f32)
        reset = np.zeros(4, bool)
        for half, d in ((slice(0, 2), props["left_direction"]),
                        (slice(2, 4), props["right_direction"])):
            if d == 0:      # AL_FREQUENCY_SHIFTER_DIRECTION_DOWN
                signs[half] = -1.0
            elif d == 2:    # OFF: zero the phase and freeze it
                steps[half] = 0
                reset[half] = True
        _, gains = ambi_mix_params(self.device, slot.gain)
        return {"step": steps, "sign": signs,
                "phase_reset": reset, "gain_tgt": gains[:4]}

    def process(self, state, params, wet, T: int):
        n_in = min(wet.shape[0], 4)
        dev = wet.device
        a_in = torch.matmul(const(B2A, dev)[:, :n_in], wet[:n_in])
        win = const(_WINDOW, dev)
        w2 = win * f32(2.0 / OVERSAMPLE)
        fifo, out_fifo = state["in_fifo"], state["out_fifo"]
        accum, pos = state["accum"], state["pos"]
        step_i = torch.arange(HIL_STEP, dtype=torch.int64, device=wet.device)
        outs = []
        for k in range(T // HIL_STEP):
            # Copy out the previous frame's result, then stage new input.
            outs.append(out_fifo)
            fifo = fifo.index_copy(1, pos + step_i,
                                   a_in[:, k * HIL_STEP:(k + 1) * HIL_STEP])
            pos = (pos + HIL_STEP) & (HIL_SIZE - 1)
            fwd, back = rotation(pos, HIL_SIZE)
            # Window the rotated FIFO and take the analytic signal.
            re, im = complex_hilbert(fifo[:, fwd] * win,
                                     const(_HIL_MASK, dev))
            # Overlap-add into the rotated accumulator.
            acc_rot = accum[:, :, fwd] + torch.stack([re * w2, im * w2])
            out_fifo = acc_rot[:, :, :HIL_STEP].clone()
            acc_rot[:, :, :HIL_STEP] = 0.0
            accum = acc_rot[:, :, back]
        outdata = torch.stack(outs, 2).reshape(2, 4, T)

        # Single-sideband modulation (fshifter.cpp:305-331).
        phase0 = torch.where(params["phase_reset"], 0, state["phase"])
        step = params["step"].to(torch.int64)
        i = torch.arange(T, dtype=torch.int64, device=wet.device)
        idx = (phase0[:, None] + i[None, :] * step[:, None]) & MIXER_FRAC_MASK
        ph = idx.to(torch.float32) * f32(2.0 * np.pi / MIXER_FRAC_ONE)
        shifted = (outdata[0] * torch.cos(ph)
                   + outdata[1] * torch.sin(ph) * params["sign"][:, None])

        out, new_cur = effect_mix(torch.matmul(const(A2B, dev), shifted),
                                  state["gain_cur"], params["gain_tgt"], T)
        state["in_fifo"].copy_(fifo)
        state["out_fifo"].copy_(out_fifo)
        state["accum"].copy_(accum)
        state["pos"].copy_(pos)
        state["phase"].copy_((phase0 + step * T) & MIXER_FRAC_MASK)
        state["gain_cur"].copy_(new_cur)
        return out, None, state
