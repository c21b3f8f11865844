"""Convolution reverb (alc/effects/convolution.cpp; port of
effects/convolution.py).

Partitioned FFT convolution of the wet W channel with a (multi-channel)
impulse-response buffer: the first 128 IR taps run as a zero-latency
time-domain FIR (one [C, 128] x [128, 128] product per sub-block), the
remaining segments convolve in the frequency domain against a newest-first
ring of input-partition spectra (256-point FFTs of 128-sample zero-padded
partitions, ``torch.fft``), with the reference's segmentation
(ConvolveUpdateSize=256 / 128-sample partitions, convolution.cpp:152-153).
The sub-blocks are a Python loop over batched torch ops.  Filter spectra
are prepared in float64 like the reference's double-precision forward FFT
(convolution.cpp:394-400); UHJ impulse responses decode to B-Format with
the FIR512 decoder (ops/uhj.py) when they are baked.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ambidefs, panning
from ..core.devformat import (CHAN_POS_MAPS, AmbiLayout, AmbiScaling, Channel,
                              FmtChannels, is_ambisonic, is_uhj)
from ..ops import filters as f_ops
from ..ops import uhj as uhj_ops
from .base import EffectState, const, effect_mix, register

f32 = np.float32

SEG = 128           # ConvolveUpdateSamples
FFT = 256           # ConvolveUpdateSize

# First-order cap on ambisonic IRs (convolution.cpp:273 MaxConvolveAmbiOrder).
MAX_CONVOLVE_AMBI_ORDER = 1

_2D_FMTS = (FmtChannels.BFORMAT2D, FmtChannels.UHJ2, FmtChannels.UHJ3,
            FmtChannels.SUPER_STEREO)   # buffer_storage.h:27 Is2DAmbisonic

# Static index matrix for the time-domain FIR:
# out[i] = sum_k ir[k] * in[SEG + i - k], in = prev 128 ++ new 128.
_WIN_IDX = (SEG + np.arange(SEG)[:, None] - np.arange(SEG)[None, :])


def uhj_decode_fir512(data: np.ndarray) -> np.ndarray:
    """A UHJ impulse response [N, 2..4] decoded to first-order B-Format
    [N, 3 or 4] (W, X, Y[, Z]) with the FIR512 decoder on the CPU, in 4096-
    frame blocks (the JAX package's utils/uhjdecoder.decode)."""
    block, nfir = 4096, 512
    n_in, n = data.shape[1], data.shape[0]
    pad = uhj_ops.fir_pad(nfir)
    hist = uhj_ops.fir_hist(nfir)
    x = np.pad(data.T.astype(f32), ((0, 4 - n_in if n_in < 3 else 0),
                                    (0, pad + (-n) % block)))
    x = torch.tensor(x[:4 if n_in >= 4 else 3])
    dt_hist = torch.zeros((1, hist), dtype=torch.float32)
    s_hist = torch.zeros((1, hist), dtype=torch.float32)
    outs = []
    for i in range(0, n + (-n) % block, block):
        dec, dt_hist, s_hist = uhj_ops.uhj_decode(
            x[None, :, i:i + block + pad], dt_hist, s_hist, block, n_in, nfir)
        outs.append(dec[0].numpy().T)
    return np.concatenate(outs)[:n]


@register("convolution")
class ConvolutionEffect(EffectState):
    defaults = {"buffer": None, "orient_at": (0.0, 0.0, -1.0),
                "orient_up": (0.0, 1.0, 0.0)}

    def __init__(self, device) -> None:
        super().__init__(device)
        self.n_chan = 0
        self.n_segs = 0
        self.fmt_channels = None
        self._fir = None           # [C, 128] f32, time order
        self._freq_filter = None   # [C, S, 129] complex64
        # Ambisonic IR metadata (convolution.cpp:294-297): UHJ IRs decode to
        # B-Format with FuMa ordering / N3D scaling; capped at first order.
        self.ambi_layout = AmbiLayout.FUMA
        self.ambi_scaling = AmbiScaling.FUMA
        self.ambi_order = 0
        # UpsampleMix (convolution.cpp:486-509): per-channel band-split
        # HF/LF scale before the pan when the IR's order is below the
        # device's (or the UHJ2 shelving when the device isn't UHJ-out).
        self._upsample = False
        self._hf_scale = np.ones(1, f32)    # [C]
        self._lf_scale = np.ones(1, f32)    # [C]
        self._splitter_k = f_ops.BandSplitterKernels(
            float(f_ops.band_splitter_coeff(device.layout.xover_f0norm)))

    def device_update(self, buffer=None) -> dict:
        self._bake(buffer)
        C = max(self.n_chan, 1)
        S = max(self.n_segs, 1)
        ff = (self._freq_filter if self._freq_filter is not None
              else np.zeros((C, S, FFT // 2 + 1), np.complex64))
        fir = self._fir if self._fir is not None else np.zeros((C, SEG), f32)
        dev = self.device.torch_device
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,  # noqa: E731
                                       device=dev)
        return {
            "fifo": z(FFT),                          # prev 128 ++ new 128
            "freq_hist": z(S, FFT // 2 + 1, 2),
            "out_overlap": z(C, FFT),
            "gain_cur": z(C, self.device.n_dry),
            "split_z": z(C, 3),                      # UpsampleMix state
            "fir_c": torch.tensor(fir, device=dev),
            "flt_re": torch.tensor(np.real(ff).astype(f32), device=dev),
            "flt_im": torch.tensor(np.imag(ff).astype(f32), device=dev),
        }

    def _bake(self, buffer) -> None:
        """deviceUpdate (convolution.cpp:268-421): partition the IR."""
        self.n_chan = self.n_segs = 0
        self._fir = self._freq_filter = None
        self.ambi_order = 0
        self._upsample = False
        if buffer is None or getattr(buffer, "sample_len", 0) < 1:
            return
        fmt = buffer.fmt_channels
        data = buffer.data.astype(np.float64)          # [C, N] planar
        if is_uhj(fmt):
            # UHJ IRs decode to B-Format up front with the FIR512 decoder
            # (convolution.cpp:270 UhjDecoder<512>, :343-360); the decoded
            # set is FuMa-ordered (W,X,Y[,Z]) with N3D scaling (:295-296).
            data = uhj_decode_fir512(data.T.astype(f32)).T.astype(np.float64)
            self.ambi_layout = AmbiLayout.FUMA
            self.ambi_scaling = AmbiScaling.N3D
            self.ambi_order = 1
        elif is_ambisonic(fmt):
            self.ambi_layout = buffer.ambi_layout
            self.ambi_scaling = buffer.ambi_scaling
            self.ambi_order = min(buffer.ambi_order, MAX_CONVOLVE_AMBI_ORDER)
            # Only the first-order channels convolve (order capped).
            n_keep = (self.ambi_order * 2 + 1 if fmt == FmtChannels.BFORMAT2D
                      else (self.ambi_order + 1) ** 2)
            data = data[:n_keep]
        if buffer.sample_rate != self.device.sample_rate:
            from ..utils.polyphase import polyphase_resample
            data = np.stack([polyphase_resample(row, buffer.sample_rate,
                                                self.device.sample_rate)
                             for row in data])
        C, N = data.shape
        self.n_chan = C
        self.fmt_channels = fmt
        hf = np.ones(C, f32)
        lf = np.ones(C, f32)
        if is_ambisonic(fmt):
            layout = self.device.layout
            if fmt == FmtChannels.UHJ2 and not layout.uhj_output:
                self._upsample = True
                lf[:] = [0.661, 1.293, 1.293]   # sWLFScale / sXYLFScale
            elif layout.ambi_order > self.ambi_order:
                self._upsample = True
                scales = ambidefs.hf_order_scales(
                    self.ambi_order, layout.ambi_order, layout.m2d_mixing)
                hf[0] = scales[0]
                hf[1:] = scales[1]
        self._hf_scale = hf
        self._lf_scale = lf
        self.n_segs = max((N + SEG - 1) // SEG, 2) - 1

        fir = np.zeros((C, SEG), f32)
        first = min(N, SEG)
        fir[:, :first] = data[:, :first].astype(f32)
        self._fir = fir

        spec = np.zeros((C, self.n_segs, FFT // 2 + 1), np.complex64)
        done = first
        for s in range(self.n_segs):
            todo = min(max(N - done, 0), SEG)
            seg = np.zeros((C, FFT), np.float64)
            seg[:, :todo] = data[:, done:done + todo]
            spec[:, s] = np.fft.rfft(seg, axis=1).astype(np.complex64)
            done += todo
        self._freq_filter = spec

    def update(self, slot, props) -> dict:
        dev = self.device
        C = max(self.n_chan, 1)
        tgt = np.zeros((C, dev.n_dry), f32)
        params = {"gain_tgt": tgt, "hf_scale": self._hf_scale,
                  "lf_scale": self._lf_scale}
        if self.n_chan and is_ambisonic(self.fmt_channels):
            # Ambisonic IR: first-order listener-orientation remap
            # (convolution.cpp:512-543).  N/V/U from the effect's At/Up
            # vectors; each IR channel (layout-mapped to its ACN) lands on
            # the ambi bus through the rotated row scaled to N3D.
            n = np.asarray(props.get("orient_at", (0.0, 0.0, -1.0)), f32)
            v = np.asarray(props.get("orient_up", (0.0, 1.0, 0.0)), f32)
            n = n / max(np.linalg.norm(n), 1e-20)
            v = v / max(np.linalg.norm(v), 1e-20)
            u = np.cross(n, v)
            u = u / max(np.linalg.norm(u), 1e-20)
            mixmatrix = np.array([
                [1.0,  0.0,   0.0,   0.0],
                [0.0,  u[0], -u[1],  u[2]],
                [0.0, -v[0],  v[1], -v[2]],
                [0.0, -n[0],  n[1], -n[2]],
            ], f32)
            fuma = self.ambi_layout == AmbiLayout.FUMA
            if self.fmt_channels in _2D_FMTS:
                index_map = (ambidefs.INDEX_FROM_FUMA_2D if fuma
                             else ambidefs.INDEX_FROM_ACN_2D)
            else:
                index_map = (ambidefs.INDEX_FROM_FUMA if fuma
                             else ambidefs.INDEX_FROM_ACN)
            scales = {AmbiScaling.FUMA: ambidefs.FROM_FUMA,
                      AmbiScaling.SN3D: ambidefs.FROM_SN3D,
                      AmbiScaling.N3D: ambidefs.FROM_N3D}[self.ambi_scaling]
            for c in range(self.n_chan):
                acn = int(index_map[c])
                coeffs = np.zeros(ambidefs.MAX_AMBI_CHANNELS, f32)
                coeffs[:4] = mixmatrix[acn] * scales[acn]
                tgt[c] = panning.compute_pan_gains(
                    dev.layout.dry_acn, dev.layout.dry_scale, coeffs,
                    slot.gain)
            return params
        if self.n_chan and self.fmt_channels in CHAN_POS_MAPS:
            chanmap = CHAN_POS_MAPS[self.fmt_channels]
            pairwise = dev.layout.mode == panning.RenderMode.PAIRWISE
            for i, (ch, pos) in enumerate(chanmap[:C]):
                if ch == Channel.LFE:
                    continue
                p = np.array(pos, f32)
                if pairwise:
                    p = panning.scale_azimuth_front3(p)
                coeffs = ambidefs.calc_direction_coeffs(p, 0.0)
                tgt[i] = panning.compute_pan_gains(
                    dev.layout.dry_acn, dev.layout.dry_scale, coeffs,
                    slot.gain)
        return params

    def process(self, state, params, wet, T: int):
        if self.n_chan == 0 or self.n_segs == 0:
            return (torch.zeros((self.device.n_dry, T), dtype=torch.float32,
                                device=wet.device), None, state)
        assert T % SEG == 0
        flt = torch.complex(state["flt_re"], state["flt_im"])   # [C, S, 129]
        fir = state["fir_c"]
        fifo, fhist = state["fifo"], state["freq_hist"]
        overlap = state["out_overlap"]
        win_idx = const(_WIN_IDX, wet.device)
        outs = []
        for x_new in wet[0].reshape(T // SEG, SEG):
            inbuf = torch.cat([fifo[SEG:], x_new])             # [256]
            out = torch.matmul(fir, inbuf[win_idx].T) \
                + overlap[:, :SEG]

            # Newest-first spectra ring of zero-padded partitions.
            frame = torch.fft.rfft(x_new, n=FFT)
            fhist = torch.cat([torch.stack([frame.real, frame.imag],
                                           -1)[None], fhist[:-1]])
            fhc = torch.complex(fhist[..., 0], fhist[..., 1])  # [S, 129]
            acc = (fhc[None] * flt).sum(1)                     # [C, 129]
            y = torch.fft.irfft(acc, n=FFT, dim=1)             # [C, 256]
            overlap = torch.cat([y[:, :SEG] + overlap[:, SEG:], y[:, SEG:]],
                                dim=1)
            fifo = inbuf
            outs.append(out)
        out_lines = torch.cat(outs, 1)                         # [C, T]

        if self._upsample:
            # UpsampleMix (convolution.cpp:256-265): band-split HF/LF scale
            # per channel ahead of the pan (first-order IR on a higher-order
            # bus, or the UHJ2 W/XY LF shelving).
            out_lines, sp = self._splitter_k.scale(
                out_lines, state["split_z"], params["hf_scale"],
                params["lf_scale"])
            state["split_z"].copy_(sp)
        mixed, new_cur = effect_mix(out_lines, state["gain_cur"],
                                    params["gain_tgt"], T)
        for key, v in (("fifo", fifo), ("freq_hist", fhist),
                       ("out_overlap", overlap), ("gain_cur", new_cur)):
            state[key].copy_(v)
        return mixed, None, state
