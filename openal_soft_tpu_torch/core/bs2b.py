"""Bauer stereophonic-to-binaural crossfeed (core/bs2b.cpp).

Applied as the final stereo post-process when the ``cf_level`` config picks
a crossfeed level (alc/alc.cpp Bs2bPostProcess).  Each ear keeps its direct
signal through a first-order high-path and receives the opposite ear
through a first-order low-pass.  Host-side stateful filtering (like
distance comp): every recurrence is the one-pole form
``y[n] = v[n] + b1*y[n-1]``, evaluated vectorized per 128-sample chunk
with a b1^k geometric rescale (f64 keeps b1^-127 well-conditioned),
sequential only across chunks.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32

# cf_level 1..6 (bs2b.cpp:45-67): (Fc_lo, Fc_hi, G_lo, G_hi)
LEVELS = {
    1: (360.0, 501.0, 0.398107170553497, 0.205671765275719),
    2: (500.0, 711.0, 0.459726988530872, 0.228208484414988),
    3: (700.0, 1021.0, 0.530884444230988, 0.250105790667544),
    4: (360.0, 494.0, 0.316227766016838, 0.168236228897329),
    5: (500.0, 689.0, 0.354813389233575, 0.187169483835901),
    6: (700.0, 975.0, 0.398107170553497, 0.205671765275719),
}


def _one_pole(v: np.ndarray, b1: float, seed: float) -> np.ndarray:
    """y[n] = v[n] + b1*y[n-1], with b1*y[-1] = seed.  f64 in/out."""
    n = v.shape[0]
    out = np.empty(n, np.float64)
    for s in range(0, n, 128):
        c = v[s:s + 128]
        m = c.shape[0]
        w = b1 ** np.arange(m, dtype=np.float64)
        y = w * np.cumsum(c / w) + seed * w
        out[s:s + m] = y
        seed = b1 * y[-1]
    return out


class Bs2bProcessor:
    """bs2b_processor: set_params + cross_feed (bs2b.cpp:41-163)."""

    def __init__(self, level: int, srate: int) -> None:
        if level not in LEVELS:
            level = 6
        fc_lo, fc_hi, g_lo, g_hi = LEVELS[level]
        self.level = level
        g = 1.0 / (1.0 - g_hi + g_lo)
        x = float(np.exp(-2.0 * np.pi * fc_lo / srate))
        self.b1_lo = x
        self.a0_lo = g_lo * (1.0 - x) * g
        x = float(np.exp(-2.0 * np.pi * fc_hi / srate))
        self.b1_hi = x
        self.a0_hi = (1.0 - g_hi * (1.0 - x)) * g
        self.a1_hi = -x * g
        # carried z per (ear, band): z is the reference's history value —
        # exactly what adds to a0*x at the next sample.
        self.z = np.zeros((2, 2), np.float64)

    def _lo(self, x: np.ndarray, ear: int) -> np.ndarray:
        # y = a0_lo*x + z;  z' = b1_lo*y  ->  seed = z_in
        y = _one_pole(self.a0_lo * x, self.b1_lo, self.z[ear, 0])
        self.z[ear, 0] = self.b1_lo * y[-1]
        return y

    def _hi(self, x: np.ndarray, ear: int) -> np.ndarray:
        # y = a0_hi*x + z;  z' = a1_hi*x + b1_hi*y
        # => y[n] = a0_hi x[n] + a1_hi x[n-1] + b1_hi y[n-1], seeded so that
        # v[0] picks up the carried z (which already holds a1*x_prev+b1*y_prev)
        v = self.a0_hi * x
        v[1:] += self.a1_hi * x[:-1]
        v[0] += self.z[ear, 1]
        y = _one_pole(v, self.b1_hi, 0.0)
        self.z[ear, 1] = self.a1_hi * x[-1] + self.b1_hi * y[-1]
        return y

    def cross_feed(self, left: np.ndarray, right: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """L' = hi(L) + lo(R); R' = lo(L) + hi(R) (bs2b.cpp:133-160)."""
        lx = left.astype(np.float64)
        rx = right.astype(np.float64)
        out_l = self._hi(lx, 0) + self._lo(rx, 1)
        out_r = self._lo(lx, 0) + self._hi(rx, 1)
        return out_l.astype(f32), out_r.astype(f32)
