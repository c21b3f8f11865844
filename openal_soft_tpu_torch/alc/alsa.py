"""ALSA playback backend (host audio out).

The real-audio analog of the reference's alc/backends/alsa.cpp: libasound
is dlopened at runtime (the reference does the same, alsa.cpp:1-60 dlopen
machinery), a PCM device is opened and configured to the render device's
format, and a mixer thread paces `render_samples` into snd_pcm_writei —
the control-flow inversion of SURVEY.md §1: the backend owns the thread
and calls *up* into the renderer.

Without a physical sound card (or libasound at all) the factory reports
unavailable, exactly like a reference backend whose library is missing.
``OPENAL_TPU_ALSA_LIB`` overrides the library path — used by the test
suite to drive the full open/reset/start/write loop against a fake
libasound that captures the PCM stream.

Port of openal_soft_tpu/alc/alsa.py, unchanged.
"""

from __future__ import annotations

import ctypes as ct
import os
import threading

import numpy as np

from ..core import logging as log
from ..core.devformat import DevFmtType

# snd_pcm_format_t values (asoundlib.h)
_SND_PCM_FORMAT = {
    DevFmtType.BYTE: 0,       # S8
    DevFmtType.UBYTE: 1,      # U8
    DevFmtType.SHORT: 2,      # S16_LE
    DevFmtType.INT: 10,       # S32_LE
    DevFmtType.FLOAT: 14,     # FLOAT_LE
}
_SND_PCM_STREAM_PLAYBACK = 0
_SND_PCM_ACCESS_RW_INTERLEAVED = 3

_lib_cache: tuple[str, object] | None = None


def _load_lib():
    """dlopen libasound (or the test override), caching the handle."""
    global _lib_cache
    name = os.environ.get("OPENAL_TPU_ALSA_LIB", "libasound.so.2")
    if _lib_cache is not None and _lib_cache[0] == name:
        return _lib_cache[1]
    try:
        lib = ct.CDLL(name)
    except OSError:
        _lib_cache = (name, None)
        return None
    try:
        lib.snd_pcm_open.restype = ct.c_int
        lib.snd_pcm_open.argtypes = [ct.POINTER(ct.c_void_p), ct.c_char_p,
                                     ct.c_int, ct.c_int]
        lib.snd_pcm_set_params.restype = ct.c_int
        lib.snd_pcm_set_params.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                           ct.c_uint, ct.c_uint, ct.c_int,
                                           ct.c_uint]
        lib.snd_pcm_writei.restype = ct.c_long
        lib.snd_pcm_writei.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_ulong]
        lib.snd_pcm_recover.restype = ct.c_int
        lib.snd_pcm_recover.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
        lib.snd_pcm_drain.restype = ct.c_int
        lib.snd_pcm_drain.argtypes = [ct.c_void_p]
        lib.snd_pcm_close.restype = ct.c_int
        lib.snd_pcm_close.argtypes = [ct.c_void_p]
    except AttributeError:
        _lib_cache = (name, None)
        return None
    _lib_cache = (name, lib)
    return lib


def available() -> bool:
    return _load_lib() is not None


class AlsaBackend:
    """Interleaved-write ALSA playback loop (alsa.cpp mixerProc analog)."""

    def __init__(self, device, pcm_name: str = "default") -> None:
        self.device = device
        self._lib = _load_lib()
        if self._lib is None:
            raise RuntimeError("libasound unavailable")
        self._pcm = ct.c_void_p()
        self._thread: threading.Thread | None = None
        self._running = False
        self.frames_written = 0
        rc = self._lib.snd_pcm_open(ct.byref(self._pcm),
                                    pcm_name.encode(),
                                    _SND_PCM_STREAM_PLAYBACK, 0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open failed ({rc})")
        self._configure()

    def _configure(self) -> None:
        """Negotiate the device format (the reference's full hw/sw-params
        dance collapsed to snd_pcm_set_params: same rate/format/channels
        contract; buffering = `periods` x `period_size` frames, default
        2 x 1024 ~= 43 ms — the alsoftrc `period_size`/`periods` keys,
        alc/alc.cpp:1412-1427)."""
        from . import config as alconf

        dev = self.device
        fmt = _SND_PCM_FORMAT[dev.fmt_type]
        period = alconf.config_value_int("", "period_size", 1024) or 1024
        period = int(np.clip(period, 64, 8192))
        nper = alconf.config_value_int("", "periods", 2) or 2
        nper = int(np.clip(nper, 2, 16))
        buffer_us = nper * period * 1_000_000 // dev.sample_rate
        rc = self._lib.snd_pcm_set_params(
            self._pcm, fmt, _SND_PCM_ACCESS_RW_INTERLEAVED,
            dev.n_real, dev.sample_rate, 1, buffer_us)
        if rc < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise RuntimeError(f"snd_pcm_set_params failed ({rc})")

    def start(self, period_frames: int = 1024) -> None:
        if self._running:
            return
        self._running = True

        def run() -> None:
            while self._running:
                data = self.device.render_samples(period_frames)
                buf = np.ascontiguousarray(data)
                ptr = buf.ctypes.data_as(ct.c_void_p)
                done = 0
                # A rendered period is always written out fully, even when
                # stop() raced in: dropping the tail would lose rendered
                # frames and break stream continuity across pause/resume.
                while done < period_frames:
                    n = self._lib.snd_pcm_writei(
                        self._pcm,
                        ct.c_void_p(ptr.value
                                    + done * buf.strides[0]),
                        period_frames - done)
                    if n < 0:
                        # Underrun/suspend: recover like the reference's
                        # verify-state path (alsa.cpp mixerProc).
                        rc = self._lib.snd_pcm_recover(self._pcm, int(n), 1)
                        if rc < 0:
                            log.err("ALSA write failed (%d); stopping", n)
                            self._running = False
                            self.device.handle_disconnect(
                                f"ALSA write error {n}")
                            return
                        continue
                    done += int(n)
                self.frames_written += done

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="alsa-mixer")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._lib.snd_pcm_drain(self._pcm)

    def close(self) -> None:
        self.stop()
        if self._pcm:
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = ct.c_void_p()


# --- capture (record) side ----------------------------------------------------

_SND_PCM_STREAM_CAPTURE = 1


def _bind_capture_syms(lib) -> bool:
    """Bind the record-side entry points (alsa.cpp:900-1100 uses the same
    set); returns False if the library lacks them."""
    try:
        lib.snd_pcm_readi.restype = ct.c_long
        lib.snd_pcm_readi.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_ulong]
        lib.snd_pcm_avail_update.restype = ct.c_long
        lib.snd_pcm_avail_update.argtypes = [ct.c_void_p]
        lib.snd_pcm_start.restype = ct.c_int
        lib.snd_pcm_start.argtypes = [ct.c_void_p]
        lib.snd_pcm_drop.restype = ct.c_int
        lib.snd_pcm_drop.argtypes = [ct.c_void_p]
    except AttributeError:
        return False
    return True


def capture_available() -> bool:
    lib = _load_lib()
    return lib is not None and _bind_capture_syms(lib)


class AlsaCaptureBackend:
    """snd_pcm_readi record loop (alc/backends/alsa.cpp:900-1100 analog).

    Pull-model: ``read()`` drains whatever the driver has accumulated
    (snd_pcm_avail_update bounds the readi), in the capture device's
    native int16 interleaved format; the CaptureDevice's converters adapt
    rate/type/channels from there.
    """

    def __init__(self, pcm_name: str, rate: int,
                 channels: str = "mono") -> None:
        from ..core.devformat import DevFmtType

        self._lib = _load_lib()
        if self._lib is None or not _bind_capture_syms(self._lib):
            raise RuntimeError("libasound capture unavailable")
        self.native_rate = int(rate)
        self.native_type = DevFmtType.SHORT     # S16_LE wire format
        self.native_channels = channels
        self._n_ch = {"mono": 1, "stereo": 2}[channels]
        self._pcm = ct.c_void_p()
        rc = self._lib.snd_pcm_open(ct.byref(self._pcm), pcm_name.encode(),
                                    _SND_PCM_STREAM_CAPTURE, 0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open(capture) failed ({rc})")
        buffer_us = 100_000                      # 100 ms driver buffer
        rc = self._lib.snd_pcm_set_params(
            self._pcm, _SND_PCM_FORMAT[self.native_type],
            _SND_PCM_ACCESS_RW_INTERLEAVED, self._n_ch, self.native_rate,
            1, buffer_us)
        if rc < 0:
            self._lib.snd_pcm_close(self._pcm)
            raise RuntimeError(f"snd_pcm_set_params(capture) failed ({rc})")
        self._started = False

    def start(self) -> None:
        if not self._started:
            self._lib.snd_pcm_start(self._pcm)
            self._started = True

    def stop(self) -> None:
        if self._started:
            self._lib.snd_pcm_drop(self._pcm)
            self._started = False

    def available(self) -> int:
        if not self._started:
            return 0
        n = self._lib.snd_pcm_avail_update(self._pcm)
        return max(int(n), 0)

    def read(self, max_frames: int) -> np.ndarray:
        n = min(max_frames, self.available())
        if n <= 0:
            return np.zeros((0, self._n_ch), np.int16)
        buf = np.empty((n, self._n_ch), np.int16)
        got = self._lib.snd_pcm_readi(
            self._pcm, buf.ctypes.data_as(ct.c_void_p), n)
        if got < 0:
            rc = self._lib.snd_pcm_recover(self._pcm, int(got), 1)
            if rc < 0:
                log.err("ALSA capture read failed (%d)", got)
                return np.zeros((0, self._n_ch), np.int16)
            return np.zeros((0, self._n_ch), np.int16)
        return buf[:int(got)]

    def close(self) -> None:
        self.stop()
        if self._pcm:
            self._lib.snd_pcm_close(self._pcm)
            self._pcm = ct.c_void_p()
