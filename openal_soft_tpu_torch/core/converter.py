"""Sample/channel converters for the capture path (core/converter.cpp).

Streaming rate/format conversion with the reference's exact prep-sample
and fractional-offset bookkeeping (converter.cpp:216-334): each convert()
call carries MaxResamplerPadding history samples per channel so chunked
streaming is bit-identical to a one-shot conversion.  This is host-side
control/IO plane (capture pull, backend format adaptation) — the batched
resampler kernels cover the render hot path; here the numpy spec kernels
(ops/spec.py) give sample-sequential f32 exactness at stream rates.

Port of openal_soft_tpu/core/converter.py, unchanged: host numpy code
over the port's own ops/spec.py and ops/tables.py.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    BUFFER_LINE_SIZE,
    MAX_PITCH,
    MAX_RESAMPLER_EDGE,
    MAX_RESAMPLER_PADDING,
    MIXER_FRAC_BITS,
    MIXER_FRAC_MASK,
    MIXER_FRAC_ONE,
    Resampler,
)
from ..ops import spec, tables
from .devformat import DevFmtType

f32 = np.float32


# --- format load/store (converter.cpp:28-137) ------------------------------

def load_samples(arr: np.ndarray, srctype: DevFmtType) -> np.ndarray:
    """LoadSample<T> vectorized: source dtype -> f32 in [-1, 1)."""
    if srctype == DevFmtType.FLOAT:
        return arr.astype(f32, copy=False)
    if srctype == DevFmtType.BYTE:
        return (arr.astype(f32) * f32(1.0 / 128.0)).astype(f32)
    if srctype == DevFmtType.UBYTE:
        sv = (arr.astype(np.int16) - 128).astype(np.int8)
        return (sv.astype(f32) * f32(1.0 / 128.0)).astype(f32)
    if srctype == DevFmtType.SHORT:
        return (arr.astype(f32) * f32(1.0 / 32768.0)).astype(f32)
    if srctype == DevFmtType.USHORT:
        sv = (arr.astype(np.int32) - 32768).astype(np.int16)
        return (sv.astype(f32) * f32(1.0 / 32768.0)).astype(f32)
    if srctype == DevFmtType.INT:
        return (arr.astype(f32) * f32(1.0 / 2147483648.0)).astype(f32)
    if srctype == DevFmtType.UINT:
        sv = (arr.astype(np.int64) - 2147483648).astype(np.int32)
        return (sv.astype(f32) * f32(1.0 / 2147483648.0)).astype(f32)
    raise ValueError(f"unsupported source type {srctype}")


def store_samples(x: np.ndarray, dsttype: DevFmtType) -> np.ndarray:
    """StoreSample<T> vectorized: f32 -> destination dtype.

    fastf2i is round-to-nearest-ties-even (np.rint); clamps are the
    reference's exact float bounds (converter.cpp:86-104)."""
    x = x.astype(f32, copy=False)
    if dsttype == DevFmtType.FLOAT:
        return x
    if dsttype in (DevFmtType.BYTE, DevFmtType.UBYTE):
        v = np.rint(np.clip(x * f32(128.0), -128.0, 127.0)).astype(np.int8)
        if dsttype == DevFmtType.BYTE:
            return v
        return (v.view(np.uint8) + np.uint8(128))
    if dsttype in (DevFmtType.SHORT, DevFmtType.USHORT):
        v = np.rint(np.clip(x * f32(32768.0), -32768.0, 32767.0)
                    ).astype(np.int16)
        if dsttype == DevFmtType.SHORT:
            return v
        return (v.view(np.uint16) + np.uint16(32768))
    if dsttype in (DevFmtType.INT, DevFmtType.UINT):
        scaled = np.clip((x * f32(2147483648.0)).astype(f32),
                         f32(-2147483648.0), f32(2147483520.0))
        v = np.rint(scaled).astype(np.int64).astype(np.int32)
        if dsttype == DevFmtType.INT:
            return v
        return (v.view(np.uint32) + np.uint32(2147483648))
    raise ValueError(f"unsupported destination type {dsttype}")


# --- channel conversion (converter.cpp:139-172) -----------------------------

class ChannelConverter:
    """Mono<->multi channel adaptation for capture backends."""

    def __init__(self, src_type: DevFmtType, src_step: int, chan_mask: int,
                 dst_chans: str) -> None:
        self.src_type = src_type
        self.src_step = src_step
        self.chan_mask = chan_mask
        self.dst_chans = dst_chans  # "mono" or "stereo"

    def convert(self, src: np.ndarray, frames: int) -> np.ndarray:
        """src: flat interleaved array of src dtype -> f32 interleaved."""
        if self.dst_chans == "stereo":
            # Mono2Stereo: duplicate with -3 dB (converter.cpp:140-147)
            mono = load_samples(src[:frames], self.src_type)
            out = np.empty(frames * 2, f32)
            s = (mono * f32(0.707106781187)).astype(f32)
            out[0::2] = s
            out[1::2] = s
            return out
        # Multi2Mono: sum masked channels * rsqrt(count)
        count = bin(self.chan_mask).count("1")
        scale = f32(np.sqrt(f32(1.0) / f32(count)))
        dein = src[:frames * self.src_step].reshape(frames, self.src_step)
        acc = np.zeros(frames, f32)
        mask = self.chan_mask
        while mask:
            c = (mask & -mask).bit_length() - 1
            mask &= mask - 1
            acc = (acc + load_samples(dein[:, c], self.src_type)).astype(f32)
        return (acc * scale).astype(f32)


# --- streaming rate/format converter (converter.cpp:176-473) ----------------

class SampleConverter:
    """Streaming converter: (src_type, src_rate) -> (dst_type, dst_rate).

    convert() accepts interleaved [N, C] input and returns ([M, C] output
    in the destination dtype, frames consumed).  Chunk-split invariant:
    prep samples and the fractional offset carry across calls exactly as
    converter.cpp:216-334 does.
    """

    def __init__(self, src_type: DevFmtType, dst_type: DevFmtType,
                 num_chans: int, src_rate: int, dst_rate: int,
                 resampler: Resampler = Resampler.SPLINE) -> None:
        assert num_chans >= 1 and src_rate >= 1 and dst_rate >= 1
        self.src_type = src_type
        self.dst_type = dst_type
        self.num_chans = num_chans
        self.src_prep_count = MAX_RESAMPLER_PADDING
        self.frac_offset = 0
        self.prev = np.zeros((num_chans, MAX_RESAMPLER_PADDING), f32)
        step = np.clip(round(src_rate * float(MIXER_FRAC_ONE) / dst_rate),
                       1.0, MAX_PITCH * float(MIXER_FRAC_ONE))
        self.increment = int(step)
        self.resampler = resampler
        self._table = None
        if self.increment != MIXER_FRAC_ONE:
            if resampler in (Resampler.SPLINE,):
                self._table = tables.spline_table()
            elif resampler == Resampler.GAUSSIAN:
                self._table = tables.gaussian_table()
            elif resampler >= Resampler.FAST_BSINC12:
                self._table = tables.bsinc_table_for(resampler)

    # convert() consumed-input delay, in 1/FRAC_ONE source frames
    def current_input_delay(self) -> int:
        prep = self.src_prep_count - MAX_RESAMPLER_EDGE
        return (prep << MIXER_FRAC_BITS) + self.frac_offset

    def available_out(self, srcframes: int) -> int:
        """Output frames producible from srcframes more input."""
        if srcframes < 1:
            return 0
        prepcount = self.src_prep_count
        if (prepcount < MAX_RESAMPLER_PADDING
                and MAX_RESAMPLER_PADDING - prepcount >= srcframes):
            return 0
        size = ((prepcount + srcframes - MAX_RESAMPLER_PADDING)
                << MIXER_FRAC_BITS) - self.frac_offset
        return int(np.clip(-(-size // self.increment), 1, 2**31 - 1))

    def _resample(self, src: np.ndarray, frac: int, n: int) -> np.ndarray:
        rs = self.resampler
        if rs == Resampler.POINT:
            return spec.resample_point(src, frac, self.increment, n)
        if rs == Resampler.LINEAR:
            return spec.resample_linear(src, frac, self.increment, n)
        if rs in (Resampler.SPLINE, Resampler.GAUSSIAN):
            return spec.resample_cubic(self._table, src, frac,
                                       self.increment, n)
        fast = rs in (Resampler.FAST_BSINC12, Resampler.FAST_BSINC24,
                      Resampler.FAST_BSINC48)
        return spec.resample_bsinc(self._table, src, frac, self.increment,
                                   n, fast=fast)

    def convert(self, src: np.ndarray, dstframes: int
                ) -> tuple[np.ndarray, int]:
        """Convert up to dstframes; returns (out [M, C], src frames read).

        src: [N, C] array of the source dtype (interleaved frames).
        """
        src = np.asarray(src).reshape(-1, self.num_chans)
        n_src = src.shape[0]
        increment = self.increment
        out = np.empty((dstframes, self.num_chans),
                       store_samples(np.zeros(1, f32), self.dst_type).dtype)
        pos = 0
        consumed = 0
        while pos < dstframes and n_src > 0:
            prepcount = self.src_prep_count
            readable = min(n_src, BUFFER_LINE_SIZE - prepcount)
            if (prepcount < MAX_RESAMPLER_PADDING
                    and MAX_RESAMPLER_PADDING - prepcount >= readable):
                # Not enough for one output sample: bank the input.
                loaded = load_samples(src[consumed:consumed + readable],
                                      self.src_type)
                self.prev[:, prepcount:prepcount + readable] = loaded.T
                self.src_prep_count = prepcount + readable
                consumed += readable
                n_src = 0
                break

            frac = self.frac_offset
            size = ((prepcount + readable - MAX_RESAMPLER_PADDING)
                    << MIXER_FRAC_BITS) - frac
            dst_size = int(np.clip(-(-size // increment), 1,
                                   BUFFER_LINE_SIZE))
            dst_size = min(dst_size, dstframes - pos)

            data_pos_end = dst_size * increment + frac
            src_data_end = data_pos_end >> MIXER_FRAC_BITS
            assert prepcount + readable >= src_data_end
            nextprep = min(prepcount + readable - src_data_end,
                           MAX_RESAMPLER_PADDING)

            src_data = np.zeros(BUFFER_LINE_SIZE, f32)
            loaded = load_samples(src[consumed:consumed + readable],
                                  self.src_type)  # [readable, C]
            for chan in range(self.num_chans):
                src_data[:prepcount] = self.prev[chan, :prepcount]
                src_data[prepcount:prepcount + readable] = loaded[:, chan]
                keep = src_data[src_data_end:src_data_end + nextprep]
                self.prev[chan, :keep.shape[0]] = keep
                self.prev[chan, keep.shape[0]:] = 0.0
                if increment == MIXER_FRAC_ONE and frac == 0:
                    y = src_data[MAX_RESAMPLER_EDGE:
                                 MAX_RESAMPLER_EDGE + dst_size].copy()
                else:
                    y = self._resample(src_data, frac, dst_size)
                out[pos:pos + dst_size, chan] = store_samples(
                    y, self.dst_type)

            self.src_prep_count = nextprep
            self.frac_offset = data_pos_end & MIXER_FRAC_MASK

            srcread = min(n_src, src_data_end + self.src_prep_count
                          - prepcount)
            consumed += srcread
            n_src -= srcread
            pos += dst_size

        return out[:pos], consumed
