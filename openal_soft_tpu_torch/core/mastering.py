"""Output mastering: look-ahead limiter, dither, and quantization.

The reference's output stage (alc/alu.cpp:2422-2438) runs, per <=1024-frame
block: post-process decode -> Compressor::process (core/mastering.cpp) ->
ApplyDistanceComp -> ApplyDither -> Write<T> quantization.

The limiter's gain computer is a sequential scalar recurrence (three
coupled state variables with per-sample nonlinear automation), so it runs
as native C++ on the host (the port's own native/limiter.cpp, built on
demand with g++ into the package's _build/), one call per rendered block
on the decoded [frames, channels] float32 output.  Where g++ exists, a
build or load that fails raises; only a host without g++ renders through
the pure-Python port, which is also the semantic reference for tests.

Dither is the reference's paired-LCG whitenoise (alu.cpp:2294-2318,
seed 22222); the LCG is affine mod 2^32, so the whole per-block draw
sequence is computed in closed form (vectorized numpy) instead of a
sequential loop.
"""

from __future__ import annotations

import ctypes as ct
import shutil

import numpy as np

f32 = np.float32

_LCG_A = np.uint64(96314165)
_LCG_C = np.uint64(907633515)
DITHER_SEED = 22222
_INV_RANGE = 1.0 / 4294967295.0    # 1 / UINT_MAX


def _native_lib():
    """Build (once) and load the port's native/limiter.cpp; None only where
    no g++ exists.  A failed build or load raises."""
    if shutil.which("g++") is None:
        return None
    from ..native import build

    lib = ct.CDLL(str(build.build_limiter()))
    lib.al_limiter_create.restype = ct.c_void_p
    lib.al_limiter_create.argtypes = [ct.c_int, ct.c_float, ct.c_float]
    lib.al_limiter_destroy.argtypes = [ct.c_void_p]
    lib.al_limiter_lookahead.restype = ct.c_uint
    lib.al_limiter_lookahead.argtypes = [ct.c_void_p]
    lib.al_limiter_process.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int]
    return lib


_LIB = None
_LIB_TRIED = False


def _get_lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB = _native_lib()
        _LIB_TRIED = True
    return _LIB


class Limiter:
    """Device output limiter (CreateDeviceLimiter, alc/alc.cpp:1074-1086)."""

    def __init__(self, channels: int, sample_rate: float, threshold_db: float):
        self.channels = channels
        lib = _get_lib()
        if lib is not None:
            self._h = lib.al_limiter_create(channels, sample_rate, threshold_db)
            self._lib = lib
            self.look_ahead = int(lib.al_limiter_lookahead(self._h))
        else:
            self._h = None
            self._lib = None
            self._py = _PyLimiter(channels, sample_rate, threshold_db)
            self.look_ahead = self._py.look_ahead

    def process(self, block: np.ndarray) -> None:
        """In-place on [frames, channels] float32, frames <= 1024."""
        if self._lib is not None:
            assert block.flags.c_contiguous and block.dtype == np.float32
            self._lib.al_limiter_process(
                self._h, block.ctypes.data_as(ct.c_void_p), block.shape[0])
        else:
            self._py.process(block)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.al_limiter_destroy(self._h)
            self._h = None


class _PyLimiter:
    """Pure-Python port of native/limiter.cpp: the limiter of a host
    without g++, and the test oracle."""

    def __init__(self, channels, fs, threshold_db):
        self.channels = channels
        self.look_ahead = int(np.clip(round(0.001 * fs), 0, 1023))
        self.hold = int(np.clip(round(0.002 * fs), 0, 1023))
        self.threshold = f32(np.log(10.0) / 20.0 * threshold_db)
        self.slope = f32(-1.0)
        self.attack = f32(max(1.0, 0.02 * fs))
        self.release = f32(max(1.0, 0.2 * fs))
        self.gain_est = f32(self.threshold * -0.5 * self.slope)
        self.a_adp = f32(np.exp(-1.0 / (2.0 * fs)))
        self.a_crest = f32(np.exp(-1.0 / (0.2 * fs)))
        self.y2p = f32(0.0)
        self.y2r = f32(0.0)
        self.y1 = f32(0.0)
        self.yL = f32(0.0)
        self.cdev = f32(0.0)
        self.sc = np.zeros(self.look_ahead + 1024, f32)
        self.delay = np.zeros((channels, max(self.look_ahead, 1)), f32)
        self.hold_q: list[tuple[float, int]] = [(-np.inf, self.hold)]

    def process(self, block: np.ndarray) -> None:
        n = block.shape[0]
        la = self.look_ahead
        sc = self.sc
        sc[la:la + n] = np.abs(block).max(axis=1)

        crest = np.empty(n, f32)
        y2p, y2r, a = self.y2p, self.y2r, self.a_crest
        x2s = np.clip(sc[la:la + n] ** 2, 1e-6, 1e6)
        for i in range(n):
            x2 = x2s[i]
            y2p = max(x2, x2 + (y2p - x2) * a)
            y2r = x2 + (y2r - x2) * a
            crest[i] = y2p / y2r
        self.y2p, self.y2r = f32(y2p), f32(y2r)

        if self.hold > 1:
            q = self.hold_q
            for i in range(n):
                xg = np.log(max(1e-6, sc[la + i]))
                while q and q[-1][0] <= xg:
                    q.pop()
                q.append((xg, i + self.hold))
                while q[0][1] <= i:
                    q.pop(0)
                sc[la + i] = q[0][0]
            self.hold_q = [(v, e - n) for v, e in q]
        else:
            sc[la:la + n] = np.log(np.maximum(1e-6, sc[la:la + n]))

        y1, yL, cdev = self.y1, self.yL, self.cdev
        thr, slope, est, a_adp = self.threshold, self.slope, self.gain_est, self.a_adp
        gains = np.empty(n, f32)
        for i in range(n):
            look = sc[la + i]
            knee = max(0.0, 2.5 * (cdev + est))
            kh = 0.5 * knee
            xo = look - thr
            if xo <= -kh:
                yG = 0.0
            elif abs(xo) < kh:
                yG = (xo + kh) * (xo + kh) / (2.0 * knee)
            else:
                yG = xo
            t_att = 2.0 * self.attack / crest[i]
            a_att = np.exp(-1.0 / t_att)
            t_rel = 2.0 * self.release / crest[i] - t_att
            a_rel = np.exp(-1.0 / t_rel)
            xL = -slope * yG
            y1 = max(xL, xL + (y1 - xL) * a_rel)
            yL = y1 + (yL - y1) * a_att
            cdev = -(yL + est) + (cdev + yL + est) * a_adp
            cdev = max(cdev, sc[i] - yL - thr - est)
            gains[i] = np.exp(-(cdev + est) - yL)
        self.y1, self.yL, self.cdev = f32(y1), f32(yL), f32(cdev)

        if la > 0:
            joined = np.concatenate([self.delay.T, block], axis=0)  # [la+n, C]
            block[:] = joined[:n]
            self.delay = joined[n:n + la].T.copy()
        block *= gains[:, None]
        sc[:la] = sc[n:n + la]


class DitherState:
    """ApplyDither (alc/alu.cpp:2294-2318), closed-form LCG draws."""

    def __init__(self, depth_bits: int):
        self.quant_scale = f32(1 << (depth_bits - 1)) if depth_bits > 0 else f32(0.0)
        self.seed = np.uint64(DITHER_SEED)
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _affine(self, n: int):
        # seq[k] = A[k]*seed + B[k] (mod 2^32) for k = 1..n
        got = self._cache.get(n)
        if got is None:
            A = np.empty(n, np.uint64)
            B = np.empty(n, np.uint64)
            a, b = np.uint64(1), np.uint64(0)
            m = np.uint64(0xFFFFFFFF)
            for k in range(n):
                a = (a * _LCG_A) & m
                b = (b * _LCG_A + _LCG_C) & m
                A[k] = a
                B[k] = b
            self._cache[n] = (A, B)
            got = (A, B)
        return got

    def apply(self, x: np.ndarray) -> np.ndarray:
        """x: [frames, channels] f32; returns dithered copy; advances seed."""
        if not self.quant_scale > 0.0:
            return x
        frames, chans = x.shape
        n = 2 * frames * chans
        A, B = self._affine(n)
        m = np.uint64(0xFFFFFFFF)
        seq = ((A * self.seed + B) & m).astype(np.float64)
        self.seed = np.uint64((int(A[-1]) * int(self.seed) + int(B[-1])) & 0xFFFFFFFF)
        # Draw order: per channel line, two draws per sample (channel-major).
        seq = seq.reshape(chans, frames, 2)
        noise = ((seq[:, :, 0] - seq[:, :, 1]) * _INV_RANGE).astype(f32).T
        qs = self.quant_scale
        val = (x * qs).astype(f32) + noise
        return (np.rint(val) * f32(1.0 / qs)).astype(f32)


def default_dither_depth(fmt_name: str) -> int:
    """Default dither depth per output type (alc/alc.cpp:1677-1703)."""
    return {"BYTE": 8, "UBYTE": 8, "SHORT": 16, "USHORT": 16}.get(fmt_name, 0)


def limiter_threshold_db(fmt_name: str, dither_depth_bits: int) -> float:
    """Integer-format headroom threshold (alc/alc.cpp:1738-1757)."""
    thr = {"BYTE": 127.0 / 128.0, "UBYTE": 127.0 / 128.0,
           "SHORT": 32767.0 / 32768.0, "USHORT": 32767.0 / 32768.0}.get(
        fmt_name, 1.0)
    if dither_depth_bits > 0:
        thr -= 1.0 / float(1 << (dither_depth_bits - 1))
    return float(np.log10(thr) * 20.0)
