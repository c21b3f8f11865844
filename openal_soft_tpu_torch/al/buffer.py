"""AL buffer objects (al/buffer.cpp).

Buffers hold decoded float32 planar sample data: upload converts the app's
interleaved typed samples (u8/i16/i32/f32/f64/mulaw/alaw/IMA4/MSADPCM) to
planar f32 and stores them into the device sample pool, where voices gather
from directly.
"""

from __future__ import annotations

import numpy as np

from ..core.devformat import (AmbiLayout, AmbiScaling, FmtChannels, FmtType,
                              channels_from_fmt, decode_to_float32)
from .adpcm import decode_ima4, decode_msadpcm

_FMT_CHANNELS = {
    "mono": FmtChannels.MONO, "stereo": FmtChannels.STEREO,
    "rear": FmtChannels.REAR, "quad": FmtChannels.QUAD,
    "x51": FmtChannels.X51, "x61": FmtChannels.X61, "x71": FmtChannels.X71,
    "bformat2d": FmtChannels.BFORMAT2D, "bformat3d": FmtChannels.BFORMAT3D,
    "uhj2": FmtChannels.UHJ2, "uhj3": FmtChannels.UHJ3, "uhj4": FmtChannels.UHJ4,
    "superstereo": FmtChannels.SUPER_STEREO,
}


class Buffer:
    """One AL buffer: host copy of f32 planar data + its pool span."""

    def __init__(self, bid: int, context) -> None:
        self.id = bid
        self.context = context
        self.fmt_channels = FmtChannels.MONO
        self.sample_rate = 0
        self.sample_len = 0
        self.channels = 1
        self.ambi_order = 0
        self.ambi_layout = AmbiLayout.FUMA   # AL_EXT_BFORMAT default
        self.ambi_scaling = AmbiScaling.FUMA
        self.loop_start = 0
        self.loop_end = 0
        self.data: np.ndarray | None = None     # [channels, frames] f32
        self.pool_offset = -1
        self.refcount = 0
        # AL_SOFT_callback_buffer streaming state
        self.callback = None
        self.cb_type: FmtType | None = None
        self.cb_fill = 0
        self.cb_done = False
        self.plane_stride = 0

    def set_data(self, data, channels: str | FmtChannels, sample_type: str | FmtType,
                 sample_rate: int, *, ambi_order: int = 0,
                 samples_per_block: int = 0) -> None:
        """alBufferData (al/buffer.cpp:842): decode + upload to the pool."""
        fmt = _FMT_CHANNELS[channels] if isinstance(channels, str) else channels
        styp = FmtType(sample_type) if isinstance(sample_type, str) else sample_type
        if fmt in (FmtChannels.BFORMAT2D, FmtChannels.BFORMAT3D,
                   FmtChannels.UHJ2, FmtChannels.UHJ3, FmtChannels.UHJ4,
                   FmtChannels.SUPER_STEREO):
            # B-Format and UHJ buffers are first-order (al/buffer.cpp:317-318)
            ambi_order = ambi_order or 1
        nch = channels_from_fmt(fmt, ambi_order)

        if styp == FmtType.IMA4:
            planar = decode_ima4(np.asarray(data, np.uint8), nch,
                                 samples_per_block or 65)
        elif styp == FmtType.MSADPCM:
            planar = decode_msadpcm(np.asarray(data, np.uint8), nch,
                                    samples_per_block or 64)
        else:
            arr = np.asarray(data)
            flat = decode_to_float32(arr.ravel(), styp)
            frames = flat.size // nch
            planar = flat[: frames * nch].reshape(frames, nch).T.copy()

        self.fmt_channels = fmt
        self.sample_rate = int(sample_rate)
        self.channels = nch
        self.ambi_order = ambi_order
        self.orig_type = styp
        self.orig_align = samples_per_block or (65 if styp == FmtType.IMA4
                                                else 64 if styp == FmtType.MSADPCM
                                                else 1)
        self.sample_len = planar.shape[1]
        self.loop_start = 0
        self.loop_end = self.sample_len
        self.data = np.ascontiguousarray(planar, np.float32)

        dev = self.context.device
        with dev.lock:   # pool writes race the render thread's upload
            pool = dev.pool
            if self.pool_offset >= 0:
                pool.free(self.pool_offset, self._pool_size)
            self.pool_offset = pool.alloc(self.data)
            self._pool_size = self.data.size

    # AL_SOFT_callback_buffer: a fixed pool segment streams from a pull
    # callback instead of holding static data.  ~16k frames covers a full
    # 1024-frame dispatch at the 10x max pitch plus resampler padding.
    CB_SEGMENT = 16384

    def set_callback(self, callback, channels: str | FmtChannels,
                     sample_type: str | FmtType, sample_rate: int) -> None:
        """alBufferCallbackSOFT (al/buffer.cpp:874).

        ``callback(frames) -> array`` returns up to ``frames`` interleaved
        samples of the declared type; returning fewer (or none) ends the
        stream.  The host pulls ahead of the voice each dispatch
        (alc/context.py:_feed_callbacks)."""
        fmt = _FMT_CHANNELS[channels] if isinstance(channels, str) else channels
        styp = FmtType(sample_type) if isinstance(sample_type, str) else sample_type
        from ..core.devformat import is_ambisonic
        nch = channels_from_fmt(fmt, 1 if is_ambisonic(fmt) else 0)
        self.fmt_channels = fmt
        self.sample_rate = int(sample_rate)
        self.channels = nch
        self.sample_len = 0
        self.loop_start = self.loop_end = 0
        self.data = None
        self.callback = callback
        self.cb_type = styp
        self.cb_fill = 0
        self.cb_done = False
        self.plane_stride = self.CB_SEGMENT
        pool = self.context.device.pool
        if self.pool_offset >= 0:
            pool.free(self.pool_offset, self._pool_size)
        self.pool_offset = pool.alloc(np.zeros(nch * self.CB_SEGMENT,
                                               np.float32))
        self._pool_size = nch * self.CB_SEGMENT

    def set_loop_points(self, start: int, end: int) -> None:
        if not (0 <= start < end <= self.sample_len):
            raise ValueError("invalid loop points")
        self.loop_start, self.loop_end = start, end
