"""Capture devices (alcCaptureOpenDevice, alc/alc.cpp:3175-3385).

The reference's capture path is: an OS backend produces frames in its
native (rate, type, channels); a ChannelConverter and/or SampleConverter
adapt them to the application's requested format; a ring buffer of
``buffer_frames`` holds converted frames until alcCaptureSamples drains
them.  Here backends are pull-model and deterministic-by-default: a wrapped
array or WAV file serves as the "microphone", optionally paced by wall
clock like a real driver (backends/wave.cpp's timer model).

Port of openal_soft_tpu/alc/capture.py; ``open_capture_backend`` also
passes the requested buffer size to the PulseAudio capture ring, which
holds no more than that.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from ..constants import Resampler
from ..core.converter import ChannelConverter, SampleConverter, load_samples
from ..core.devformat import DevFmtType

f32 = np.float32

_TYPES = {
    "uint8": DevFmtType.UBYTE,
    "int8": DevFmtType.BYTE,
    "int16": DevFmtType.SHORT,
    "uint16": DevFmtType.USHORT,
    "int32": DevFmtType.INT,
    "uint32": DevFmtType.UINT,
    "float32": DevFmtType.FLOAT,
}
_NP_OF = {
    DevFmtType.UBYTE: np.uint8, DevFmtType.BYTE: np.int8,
    DevFmtType.SHORT: np.int16, DevFmtType.USHORT: np.uint16,
    DevFmtType.INT: np.int32, DevFmtType.UINT: np.uint32,
    DevFmtType.FLOAT: np.float32,
}
_N_CHANNELS = {"mono": 1, "stereo": 2}


class ArrayCaptureBackend:
    """A numpy array as the capture hardware stream.

    paced=False (default): the whole array is available immediately —
    deterministic for tests.  paced=True: frames accrue at native_rate wall
    clock after start(), like a real driver.
    """

    def __init__(self, data: np.ndarray, rate: int,
                 sample_type: str = "float32", channels: str = "mono",
                 paced: bool = False, loop: bool = False) -> None:
        self.native_rate = int(rate)
        self.native_type = _TYPES[sample_type]
        self.native_channels = channels
        n_ch = _N_CHANNELS[channels]
        self.data = np.asarray(data, _NP_OF[self.native_type]).reshape(-1, n_ch)
        self.paced = paced
        self.loop = loop
        self._read_pos = 0
        self._start_time: float | None = None
        self._paused_avail = 0

    def start(self) -> None:
        self._start_time = time.monotonic()

    def stop(self) -> None:
        if self.paced and self._start_time is not None:
            self._paused_avail = self._clocked_frames()
        self._start_time = None

    def _clocked_frames(self) -> int:
        elapsed = time.monotonic() - self._start_time
        return self._paused_avail + int(elapsed * self.native_rate)

    def available(self) -> int:
        total = self.data.shape[0]
        if self.paced:
            if self._start_time is None:
                limit = self._paused_avail
            else:
                limit = self._clocked_frames()
            if not self.loop:
                limit = min(limit, total)
            return limit - self._read_pos
        if self.loop:
            return total  # always a full pass available
        return total - self._read_pos

    def read(self, max_frames: int) -> np.ndarray:
        n = min(max_frames, self.available())
        total = self.data.shape[0]
        if not self.loop:
            out = self.data[self._read_pos:self._read_pos + n]
            self._read_pos += n
            return out
        idx = (self._read_pos + np.arange(n)) % total
        self._read_pos = (self._read_pos + n) % total if not self.paced \
            else self._read_pos + n
        return self.data[idx % total]


class WavCaptureBackend(ArrayCaptureBackend):
    """A RIFF/WAVE file as the capture stream (PCM u8/i16/i32 or float32)."""

    def __init__(self, path: str, paced: bool = False,
                 loop: bool = False) -> None:
        rate, sample_type, channels, data = _read_wav(path)
        super().__init__(data, rate, sample_type, channels, paced=paced,
                         loop=loop)


def _read_wav(path: str):
    with open(path, "rb") as fh:
        riff, _size, wave = struct.unpack("<4sI4s", fh.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            cid, clen = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", fh.read(16))
                fh.read(clen - 16)
            elif cid == b"data":
                data = fh.read(clen)
            else:
                fh.seek(clen + (clen & 1), 1)
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
        tag, n_ch, rate, _br, _ba, bits = fmt
        if tag == 3 and bits == 32:
            arr, st = np.frombuffer(data, "<f4"), "float32"
        elif tag == 1 and bits == 16:
            arr, st = np.frombuffer(data, "<i2"), "int16"
        elif tag == 1 and bits == 32:
            arr, st = np.frombuffer(data, "<i4"), "int32"
        elif tag == 1 and bits == 8:
            arr, st = np.frombuffer(data, "u1"), "uint8"
        else:
            raise ValueError(f"{path}: unsupported wav format {tag}/{bits}")
        channels = {1: "mono", 2: "stereo"}.get(n_ch)
        if channels is None:
            raise ValueError(f"{path}: unsupported channel count {n_ch}")
        return rate, st, channels, arr.reshape(-1, n_ch)


class CaptureDevice:
    """The ALC capture device: backend -> converters -> ring buffer.

    Mirrors alc.cpp:3269-3385: start/stop gate accrual, available_samples
    reports converted frames ready, capture_samples raises on over-read.
    """

    def __init__(self, backend, frequency: int, channels: str = "mono",
                 sample_type: str = "int16", buffer_frames: int = 16384,
                 resampler: Resampler = Resampler.SPLINE) -> None:
        if buffer_frames <= 0:
            raise ValueError("ALC_INVALID_VALUE: buffer_frames <= 0")
        self.backend = backend
        self.sample_rate = int(frequency)
        self.channels = channels
        self.n_channels = _N_CHANNELS[channels]
        self.fmt_type = _TYPES[sample_type]
        self.buffer_frames = buffer_frames
        self.running = False

        # Channel adaptation first (f32), then rate/type conversion — the
        # reference backend order (e.g. backends/wasapi.cpp:2915-2935).
        self._chan_conv = None
        src_type = backend.native_type
        if backend.native_channels != channels:
            n_native = _N_CHANNELS[backend.native_channels]
            if channels == "mono":
                mask = (1 << n_native) - 1
                self._chan_conv = ChannelConverter(
                    backend.native_type, n_native, mask, "mono")
            elif channels == "stereo" and backend.native_channels == "mono":
                self._chan_conv = ChannelConverter(
                    backend.native_type, 1, 0x1, "stereo")
            else:
                raise ValueError(
                    f"ALC_INVALID_VALUE: cannot adapt "
                    f"{backend.native_channels} -> {channels}")
            src_type = DevFmtType.FLOAT
        self._converter = None
        self._type_only: DevFmtType | None = None
        if backend.native_rate != self.sample_rate:
            self._converter = SampleConverter(
                src_type, self.fmt_type, self.n_channels,
                backend.native_rate, self.sample_rate, resampler)
        elif src_type != self.fmt_type:
            # Same rate: pure type conversion, no resampler delay (the
            # reference only builds a SampleConverter when rates differ,
            # alc.cpp:3240-3260).
            self._type_only = src_type

        self._ring = np.zeros((buffer_frames, self.n_channels),
                              _NP_OF[self.fmt_type])
        self._ring_len = 0   # valid frames (FIFO at the front)

    # --- ALC surface ---

    def start(self) -> None:
        self.backend.start()
        self.running = True

    def stop(self) -> None:
        self._pump()
        self.backend.stop()
        self.running = False

    def available_samples(self) -> int:
        self._pump()
        return self._ring_len

    def capture_samples(self, frames: int) -> np.ndarray:
        self._pump()
        if frames > self._ring_len:
            raise ValueError("ALC_INVALID_VALUE: over-read "
                             f"({frames} > {self._ring_len} available)")
        out = self._ring[:frames].copy()
        rest = self._ring[frames:self._ring_len].copy()
        self._ring[:rest.shape[0]] = rest
        self._ring_len -= frames
        return out

    def close(self) -> None:
        self.running = False
        if hasattr(self.backend, "close"):
            self.backend.close()

    # --- internals ---

    def _pump(self) -> None:
        """Drain the backend through the converters into the ring."""
        if not self.running:
            return
        while self._ring_len < self.buffer_frames:
            space = self.buffer_frames - self._ring_len
            avail = self.backend.available()
            if avail <= 0:
                return
            raw = self.backend.read(min(avail, 2048))
            if raw.shape[0] == 0:
                return
            if self._chan_conv is not None:
                flat = self._chan_conv.convert(raw.reshape(-1),
                                               raw.shape[0])
                x = flat.reshape(-1, self.n_channels)
            else:
                x = raw
            if self._converter is not None:
                # Convert everything (the ring is the only cap): the
                # converter keeps its own prep history between calls.
                # want==0 still calls convert (dstframes=1) so the input
                # banks into the prep history (converter.cpp:262-274).
                want = self._converter.available_out(x.shape[0])
                y, consumed = self._converter.convert(x, max(want, 1))
                assert consumed == x.shape[0]
            elif self._type_only is not None:
                from ..core.converter import store_samples
                flat = load_samples(x.reshape(-1), self._type_only)
                y = np.asarray(store_samples(flat, self.fmt_type)
                               ).reshape(-1, self.n_channels)
            elif x.dtype != self._ring.dtype:
                y = np.asarray(
                    load_samples(x.reshape(-1), self.backend.native_type)
                ).reshape(-1, self.n_channels)
            else:
                y = x
            take = min(space, y.shape[0])
            self._ring[self._ring_len:self._ring_len + take] = y[:take]
            self._ring_len += take
            if take < y.shape[0]:
                # Ring overrun: oldest-in-ring kept, surplus dropped (the
                # reference drops what the ring can't take).
                return


def open_capture_backend(name: str | None, frequency: int,
                         channels: str = "mono", buffer_frames: int = 16384):
    """Route a capture device name to a backend (alc.cpp:3175 BackendList
    walk, capture side).

    - a path to a .wav file -> that file, wall-clock paced (a deterministic
      "microphone" for tests and offline runs);
    - otherwise PulseAudio record (the pulse/source config key) when
      libpulse-simple is present, then ALSA record on the named PCM
      (default: the alsa/capture config key or "default");
    - else a silent paced stream so capture-structured apps still run.
    """
    from . import alsa as alsa_mod
    from . import config as alconf
    from . import pulse as pulse_mod

    if name and name.endswith(".wav"):
        return WavCaptureBackend(name, paced=True, loop=True)
    if pulse_mod.available():
        try:
            src = name or alconf.config_value_str("pulse", "source") or None
            return pulse_mod.PulseCaptureBackend(src, frequency, channels,
                                                 buffer_frames)
        except RuntimeError:
            pass
    if alsa_mod.capture_available():
        pcm = (name or alconf.config_value_str("alsa", "capture")
               or "default")
        try:
            return alsa_mod.AlsaCaptureBackend(pcm, frequency, channels)
        except RuntimeError:
            pass
    # Silent fallback: zeros at the requested rate, wall-clock paced.
    zeros = np.zeros((frequency, _N_CHANNELS[channels]), np.float32)
    return ArrayCaptureBackend(zeros, frequency, "float32", channels,
                               paced=True, loop=True)
