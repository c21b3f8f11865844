"""PulseAudio playback/capture backend (host audio via libpulse-simple).

The real-audio analog of the reference's alc/backends/pulseaudio.cpp:
libpulse-simple-0 is dlopened at runtime (the reference dlopens libpulse
the same way, pulseaudio.cpp:1-80), a stream is opened with the render
device's sample spec, and a mixer thread paces ``render_samples`` into
pa_simple_write — the SURVEY §1 control-flow inversion (the backend owns
the thread and calls *up* into the renderer).  The reference drives the
full asynchronous pa_stream API with a threaded mainloop; the simple API
carries the same stream contract (format negotiation, server-side
buffering, blocking writes) without the callback machinery, which the
renderer does not need — the divergence is documented here.

Capture uses a reader thread filling a frame ring (pa_simple_read blocks
until a chunk is full — the push analog of the reference's read
callback), exposing the same available()/read() pull surface as the
ALSA capture backend.

``OPENAL_TPU_PULSE_LIB`` overrides the library path — used by the test
suite to drive the loops against a fake libpulse-simple.

Port of openal_soft_tpu/alc/pulse.py, with three differences:

  * int8 output opens: PulseAudio has no signed 8-bit format, so the
    stream negotiates PA_SAMPLE_U8 and the backend offsets each rendered
    sample by 128, as the reference backend turns DevFmtByte into
    DevFmtUByte (pulseaudio.cpp);
  * the capture ring holds at most the requested buffer size and drops
    its oldest frames past it, as the reference's capture ring does;
  * ``close()`` frees a capture stream only once its reader thread has
    left pa_simple_read: if the thread is still blocked in a read, the
    thread frees the stream itself when the read returns.
"""

from __future__ import annotations

import ctypes as ct
import os
import threading

import numpy as np

from ..core import logging as log
from ..core.devformat import DevFmtType

# pa_sample_format_t (pulse/sample.h)
_PA_SAMPLE = {
    DevFmtType.BYTE: 0,       # PA_SAMPLE_U8, offset by 128 (no S8)
    DevFmtType.UBYTE: 0,      # PA_SAMPLE_U8
    DevFmtType.SHORT: 3,      # PA_SAMPLE_S16LE
    DevFmtType.FLOAT: 5,      # PA_SAMPLE_FLOAT32LE
    DevFmtType.INT: 7,        # PA_SAMPLE_S32LE
}
_PA_STREAM_PLAYBACK = 1
_PA_STREAM_RECORD = 2


class _SampleSpec(ct.Structure):
    _fields_ = [("format", ct.c_int), ("rate", ct.c_uint32),
                ("channels", ct.c_uint8)]


class _BufferAttr(ct.Structure):
    _fields_ = [("maxlength", ct.c_uint32), ("tlength", ct.c_uint32),
                ("prebuf", ct.c_uint32), ("minreq", ct.c_uint32),
                ("fragsize", ct.c_uint32)]


_lib_cache: tuple[str, object] | None = None


def _load_lib():
    """dlopen libpulse-simple (or the test override), caching the handle."""
    global _lib_cache
    name = os.environ.get("OPENAL_TPU_PULSE_LIB", "libpulse-simple.so.0")
    if _lib_cache is not None and _lib_cache[0] == name:
        return _lib_cache[1]
    try:
        lib = ct.CDLL(name)
    except OSError:
        _lib_cache = (name, None)
        return None
    try:
        lib.pa_simple_new.restype = ct.c_void_p
        lib.pa_simple_new.argtypes = [
            ct.c_char_p, ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_char_p,
            ct.POINTER(_SampleSpec), ct.c_void_p,
            ct.POINTER(_BufferAttr), ct.POINTER(ct.c_int)]
        lib.pa_simple_write.restype = ct.c_int
        lib.pa_simple_write.argtypes = [ct.c_void_p, ct.c_void_p,
                                        ct.c_size_t, ct.POINTER(ct.c_int)]
        lib.pa_simple_read.restype = ct.c_int
        lib.pa_simple_read.argtypes = [ct.c_void_p, ct.c_void_p,
                                       ct.c_size_t, ct.POINTER(ct.c_int)]
        lib.pa_simple_drain.restype = ct.c_int
        lib.pa_simple_drain.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int)]
        lib.pa_simple_free.restype = None
        lib.pa_simple_free.argtypes = [ct.c_void_p]
    except AttributeError:
        _lib_cache = (name, None)
        return None
    _lib_cache = (name, lib)
    return lib


def available() -> bool:
    return _load_lib() is not None


def _open(lib, direction: int, dev: str | None, fmt: int, rate: int,
          channels: int, stream_name: str, frag_frames: int):
    from . import config as alconf

    ss = _SampleSpec(fmt, rate, channels)
    bytes_per = {0: 1, 3: 2, 5: 4, 7: 4}[fmt] * channels
    attr = _BufferAttr(maxlength=0xFFFFFFFF,
                       tlength=4 * frag_frames * bytes_per,
                       prebuf=0xFFFFFFFF, minreq=0xFFFFFFFF,
                       fragsize=frag_frames * bytes_per)
    err = ct.c_int(0)
    app = (alconf.config_value_str("pulse", "app-name")
           or "openal_soft_tpu")
    s = lib.pa_simple_new(None, app.encode(), direction,
                          dev.encode() if dev else None,
                          stream_name.encode(), ct.byref(ss), None,
                          ct.byref(attr), ct.byref(err))
    if not s:
        raise RuntimeError(f"pa_simple_new failed ({err.value})")
    return ct.c_void_p(s)


class PulseBackend:
    """Blocking-write playback loop (pulseaudio.cpp mixer analog)."""

    def __init__(self, device, sink: str | None = None) -> None:
        self.device = device
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError("libpulse-simple unavailable")
        fmt = _PA_SAMPLE[device.fmt_type]
        self._stream = _open(self._lib, _PA_STREAM_PLAYBACK, sink, fmt,
                             device.sample_rate, device.n_real,
                             "Playback", 1024)
        self._signed8 = device.fmt_type == DevFmtType.BYTE
        self._thread: threading.Thread | None = None
        self._running = False
        self.frames_written = 0

    def start(self, period_frames: int = 1024) -> None:
        if self._running:
            return
        self._running = True

        def run() -> None:
            err = ct.c_int(0)
            while self._running:
                data = self.device.render_samples(period_frames)
                if self._signed8:
                    data = (data.astype(np.int16) + 128).astype(np.uint8)
                buf = np.ascontiguousarray(data)
                rc = self._lib.pa_simple_write(
                    self._stream, buf.ctypes.data_as(ct.c_void_p),
                    buf.nbytes, ct.byref(err))
                if rc < 0:
                    log.err("pulse write failed (%d); stopping", err.value)
                    self._running = False
                    self.device.handle_disconnect(
                        f"pulse write error {err.value}")
                    return
                self.frames_written += period_frames

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="pulse-mixer")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err = ct.c_int(0)
        self._lib.pa_simple_drain(self._stream, ct.byref(err))

    def close(self) -> None:
        self.stop()
        if self._stream:
            self._lib.pa_simple_free(self._stream)
            self._stream = ct.c_void_p()


class PulseCaptureBackend:
    """pa_simple_read record loop behind the ALSA-style pull surface.

    A reader thread blocks on fragment-sized pa_simple_read calls and
    appends into a frame ring (the reference's stream read callback,
    pulseaudio.cpp record path); available()/read() drain it.
    """

    CHUNK = 512          # frames per blocking read

    def __init__(self, source: str | None, rate: int,
                 channels: str = "mono", buffer_frames: int = 16384) -> None:
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError("libpulse-simple capture unavailable")
        self.native_rate = int(rate)
        self.native_type = DevFmtType.SHORT
        self.native_channels = channels
        self._n_ch = {"mono": 1, "stereo": 2}[channels]
        self._stream = _open(self._lib, _PA_STREAM_RECORD, source,
                             _PA_SAMPLE[DevFmtType.SHORT], self.native_rate,
                             self._n_ch, "Capture", self.CHUNK)
        # At most ``buffer_frames`` frames are kept; past that the oldest
        # are dropped.
        self.buffer_frames = int(buffer_frames)
        self._ring: list[np.ndarray] = []
        self._ring_frames = 0
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._running = False
        self._reading = False        # the reader thread is alive
        self._free_on_exit = False   # close() left the free to the reader

    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._reading = True

        def run() -> None:
            err = ct.c_int(0)
            try:
                while self._running:
                    buf = np.empty((self.CHUNK, self._n_ch), np.int16)
                    rc = self._lib.pa_simple_read(
                        self._stream, buf.ctypes.data_as(ct.c_void_p),
                        buf.nbytes, ct.byref(err))
                    if rc < 0:
                        log.err("pulse capture read failed (%d)", err.value)
                        self._running = False
                        return
                    with self._lock:
                        self._push(buf)
            finally:
                with self._lock:
                    self._reading = False
                    if self._free_on_exit:
                        self._free_stream()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="pulse-capture")
        self._thread.start()

    def _push(self, buf: np.ndarray) -> None:
        """Append one chunk, then drop the oldest frames past the cap."""
        self._ring.append(buf)
        self._ring_frames += buf.shape[0]
        excess = self._ring_frames - self.buffer_frames
        while excess > 0:
            head = self._ring[0]
            if head.shape[0] <= excess:
                self._ring.pop(0)
                drop = head.shape[0]
            else:
                self._ring[0] = head[excess:]
                drop = excess
            self._ring_frames -= drop
            excess -= drop

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def available(self) -> int:
        with self._lock:
            return self._ring_frames

    def read(self, max_frames: int) -> np.ndarray:
        with self._lock:
            out = []
            got = 0
            while self._ring and got < max_frames:
                b = self._ring[0]
                take = min(b.shape[0], max_frames - got)
                out.append(b[:take])
                if take == b.shape[0]:
                    self._ring.pop(0)
                else:
                    self._ring[0] = b[take:]
                got += take
            self._ring_frames -= got
        if not out:
            return np.zeros((0, self._n_ch), np.int16)
        return np.concatenate(out, axis=0)

    def close(self) -> None:
        self.stop()
        with self._lock:
            if self._reading:
                # The reader is still inside pa_simple_read: it frees the
                # stream when the read returns.
                self._free_on_exit = True
                return
            self._free_stream()

    def _free_stream(self) -> None:
        if self._stream:
            self._lib.pa_simple_free(self._stream)
            self._stream = ct.c_void_p()
