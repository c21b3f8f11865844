"""Playback backends (alc/backends/).

The reference ships ~20 OS audio backends; the deterministic core of its
test strategy is the loopback/null/wave trio (SURVEY.md §4): loopback pulls
samples via the API, wave renders to a RIFF file on a timer thread, and null
renders on a clock without output.  Those three are implemented here over
the same RenderDevice; host-audio output can layer on later via a thin
native shim.

Port of openal_soft_tpu/alc/backends.py, unchanged.  A backend thread
renders on the render device's torch device; it and the API calls of
other threads serialize on the render device's lock.
"""

from __future__ import annotations

import struct
import threading
import time

import numpy as np

from ..core.devformat import DevFmtType


class WaveBackend:
    """Render to a WAV file (alc/backends/wave.cpp).

    Drives the device either synchronously via render(frames) or on a timer
    thread via start()/stop() like the reference's mixer thread.
    """

    def __init__(self, device, path: str) -> None:
        self.device = device
        self.path = path
        self._fh = open(path, "wb")
        self._frames_written = 0
        self._thread: threading.Thread | None = None
        self._running = False
        self._write_header()

    def _write_header(self) -> None:
        dev = self.device
        is_float = dev.fmt_type == DevFmtType.FLOAT
        bits = 32 if is_float or dev.fmt_type == DevFmtType.INT else \
            16 if dev.fmt_type == DevFmtType.SHORT else 8
        ch = dev.n_real
        rate = dev.sample_rate
        byterate = rate * ch * bits // 8
        fh = self._fh
        fh.seek(0)
        fh.write(b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE")
        fh.write(b"fmt " + struct.pack("<IHHIIHH", 16,
                                       3 if is_float else 1, ch, rate,
                                       byterate, ch * bits // 8, bits))
        fh.write(b"data" + struct.pack("<I", 0xFFFFFFFF))

    def render(self, frames: int) -> None:
        data = self.device.render_samples(frames)
        self._fh.write(np.ascontiguousarray(data).tobytes())
        self._frames_written += frames

    def start(self, period_frames: int = 1024) -> None:
        self._running = True

        def run() -> None:
            period = period_frames / self.device.sample_rate
            next_t = time.monotonic()
            while self._running:
                self.render(period_frames)
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def close(self) -> None:
        self.stop()
        dev = self.device
        bits = 32 if dev.fmt_type in (DevFmtType.FLOAT, DevFmtType.INT) else \
            16 if dev.fmt_type == DevFmtType.SHORT else 8
        data_len = self._frames_written * dev.n_real * bits // 8
        self._fh.seek(4)
        self._fh.write(struct.pack("<I", 36 + data_len))
        self._fh.seek(40)
        self._fh.write(struct.pack("<I", data_len))
        self._fh.close()


class NullBackend:
    """Timer-paced render with discarded output (alc/backends/null.cpp)."""

    def __init__(self, device) -> None:
        self.device = device
        self._thread: threading.Thread | None = None
        self._running = False
        self.frames_rendered = 0

    def start(self, period_frames: int = 1024) -> None:
        self._running = True

        def run() -> None:
            period = period_frames / self.device.sample_rate
            next_t = time.monotonic()
            while self._running:
                self.device.render_samples(period_frames)
                self.frames_rendered += period_frames
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
