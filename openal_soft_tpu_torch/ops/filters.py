"""Host half of ops/filters.py: the biquad interpolation schedule and the
band-splitter coefficient, in numpy.

The context mirrors the device's coefficient interpolation on the host
(``alc/context.py``), so it needs these without the device filters.  The
batched biquads and band splitters themselves are ROADMAP item A9.
"""

from __future__ import annotations

import numpy as np

INTERP_STEPS = 8
SAMPLES_PER_STEP = 32
INTERP_SAMPLES = INTERP_STEPS * SAMPLES_PER_STEP  # 256


def host_advance_interp(coeffs, target, counter, n: int):
    """Host-side mirror of the device coefficient schedule after ``n``
    samples: numpy f32 arrays, same lerp order as the device."""
    coeffs = coeffs.copy()
    counter = counter.copy()
    for _ in range(n // SAMPLES_PER_STEP):
        active = counter > 0
        counter = np.where(active, counter - SAMPLES_PER_STEP, 0)
        steps_left = counter // SAMPLES_PER_STEP
        a = (1.0 / (steps_left + 1.0)).astype(np.float32)
        lerped = (coeffs + (target - coeffs) * a[:, None, None]
                  ).astype(np.float32)
        coeffs = np.where(active[:, None, None],
                          np.where((counter == 0)[:, None, None], target,
                                   lerped), coeffs)
    return coeffs, counter


def band_splitter_coeff(f0norm) -> np.float32:
    """BandSplitter::init coefficient from the normalized crossover."""
    w = np.float32(2.0 * np.pi) * np.float32(min(float(f0norm), 0.49))
    cw = np.float32(np.cos(w))
    if cw > np.finfo(np.float32).eps:
        return np.float32((np.float32(np.sin(w)) - np.float32(1.0)) / cw)
    return np.float32(cw * np.float32(-0.5))
